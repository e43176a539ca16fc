"""A training stage's step on a mesh and on one device, and what it computed
— the steps the CPU tests and chip_smoke.py's phase 19 hold against each
other (the counterpart of the JAX package's dp/tp parity tests' steps).

A `StepCase` says how to build the stage, its state and the global batch;
`run_case` runs it on one device or as one rank of a mesh and returns the
first step's metrics, its gradients as the optimizer received them (summed
over the data group, before the clip; a sharded layer's gathered whole)
and the buffers after it (the "batch" mode's running statistics).
`rank_cases` is `run_case` for each case, as one spawned rank.
"""
from __future__ import annotations

import dataclasses
import io
import time
from typing import Callable, Optional

import numpy as np
import torch

from morig_tpu_torch.nn.mlp import get_default_norm, set_default_norm
from morig_tpu_torch.weights import randomize_
from morig_tpu_torch.parallel.sharding import (gather_tensor, make_device_mesh, shard_batch,
                                               shard_state, sharded_names)


@dataclasses.dataclass(frozen=True)
class StepCase:
    """`stage()` builds the stage (a class or a functools.partial: the case
    crosses to spawned ranks by pickle) in norm mode `norm`;
    `stage.init_state(seed)` the state, its weights then filled by
    `weights.randomize_(model, randomize)` where given (fresh heads are
    zero, which leaves most gradients of a first step zero), or loaded
    from `weights` (a torch.save'd state dict), and `model_attrs` (name,
    value) set on the model; `batch(device)` the global batch.  The steps
    draw from a generator seeded `generator_seed` on the device (None: the
    stage's default draws)."""

    name: str
    stage: Callable
    batch: Callable
    norm: str = "layer"
    seed: int = 0
    generator_seed: Optional[int] = 1
    randomize: Optional[int] = None
    weights: Optional[bytes] = None
    model_attrs: tuple = ()


def corr_stage(train_vismask: bool = False):
    """A CorrPoseStage, its visibility branch trained where asked (as from
    `vis_branch_start_epoch` on)."""
    from morig_tpu_torch.train.stages import CorrPoseStage

    stage = CorrPoseStage()
    stage.train_vismask = train_vismask
    return stage


def pose_batch(device, num_models: int = 4, degree: Optional[int] = None,
               buckets: Optional[tuple] = None, **kw):
    """`capsule_pose_dataset(num_models, **kw)` (degree-`degree` tables in
    `buckets` where given), all models at the frame pair (0, 2)."""
    from morig_tpu_torch.data.pose import PoseDataset, capsule_pose_dataset

    ds = capsule_pose_dataset(num_models=num_models, **kw)
    if degree is not None:
        ds = PoseDataset(ds.models, tpl_max_degree=degree, geo_max_degree=degree,
                         buckets=buckets)
    return ds.batch(list(range(num_models)), 0, 2, device=device)


def rig_batch(device, num_models: int = 4, pad_verts: int = 128, degree: int = 12,
              gt_pred_flow: bool = False, **kw):
    """All models of `capsule_rig_dataset(num_models, **kw)` padded to
    `pad_verts` with degree-`degree` tables; with `gt_pred_flow` pred_flow
    is gt_flow."""
    from morig_tpu_torch.data.rig import RigDataset, capsule_rig_dataset

    ds = RigDataset(capsule_rig_dataset(num_models, **kw).models, pad_verts=pad_verts,
                    tpl_max_degree=degree, geo_max_degree=degree)
    batch = ds.batch(list(range(num_models)), device=device)
    return dataclasses.replace(batch, pred_flow=batch.gt_flow) if gt_pred_flow else batch


def skel_batch(device, **kw):
    """`capsule_skel_dataset(**kw)` on `device`."""
    from morig_tpu_torch.data.skeleton_data import capsule_skel_dataset

    return capsule_skel_dataset(device=device, **kw)


def to_device(sample, device):
    """A batch (nested dataclasses of tensors) with every tensor on
    `device`, rebuilt with `dataclasses.replace` (no cached reverse
    table carried over)."""
    if torch.is_tensor(sample):
        return sample.to(device)
    if dataclasses.is_dataclass(sample):
        return dataclasses.replace(sample, **{f.name: to_device(getattr(sample, f.name), device)
                                              for f in dataclasses.fields(sample)})
    return sample


def batch_bytes(sample) -> bytes:
    """A batch saved with torch.save (on the CPU), for `stored_batch`."""
    buf = io.BytesIO()
    torch.save(to_device(sample, "cpu"), buf)
    return buf.getvalue()


def stored_batch(blob: bytes, device):
    """A batch saved by `batch_bytes`, on `device`: a StepCase's `batch`
    as functools.partial(stored_batch, blob)."""
    return to_device(torch.load(io.BytesIO(blob), weights_only=False), device)


def state_bytes(state_dict: dict) -> bytes:
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, buf)
    return buf.getvalue()


def build(case: StepCase, device):
    """(stage, state) of the case on `device`."""
    prev = get_default_norm()
    set_default_norm(case.norm)
    try:
        stage = case.stage()
        state = stage.init_state(case.seed, device=device)
    finally:
        set_default_norm(prev)
    if case.randomize is not None:
        randomize_(state.model, case.randomize)
    if case.weights is not None:
        sd = torch.load(io.BytesIO(case.weights), weights_only=True)
        state.model.load_state_dict(sd, strict=True)
    for name, value in case.model_attrs:
        setattr(state.model, name, value)
    return stage, state


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_case(case: StepCase, device, mesh=None, steps: int = 1, grads: bool = True,
             on_first: Optional[Callable] = None) -> dict:
    """The case's state and global batch on `device`, placed on `mesh` where
    given (`shard_state` with tensor parallelism where the mesh has a model
    axis, a fresh optimizer; `shard_batch`), then `steps` train steps on
    one generator.  `on_first`, where given, is a context manager factory
    the first step runs inside (chip_smoke's kernel recorders).  Returns
    the first step's `metrics`, with `grads` its gradients before the clip
    (whole, CPU) by name, the `buffers` after it (CPU), `ms` the wall time
    of each later step and the device's `peak_gib`."""
    stage, state = build(case, device)
    batch = case.batch(device)
    if mesh is not None:
        state = shard_state(state, mesh, tensor_parallel=mesh.model > 1, reinit_opt=True)
        batch = shard_batch(batch, mesh)
    gen = (None if case.generator_seed is None
           else torch.Generator(device=device).manual_seed(case.generator_seed))
    captured: dict = {}
    original = state.tx.step

    def step(m=None):
        if not captured:
            captured.update({n: p.grad.detach().clone()
                             for n, p in state.model.named_parameters() if p.grad is not None})
        return original(m)

    state.tx.step = step
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if on_first is not None:
        with on_first():
            metrics = stage.train_step(state, batch, gen, mesh=mesh)
    else:
        metrics = stage.train_step(state, batch, gen, mesh=mesh)
    del state.tx.step
    if mesh is not None:
        for n in sorted(sharded_names(state.model) & set(captured)):
            captured[n] = gather_tensor(captured[n], mesh)
    out = dict(metrics=metrics, buffers={n: b.detach().cpu().clone()
                                         for n, b in state.model.named_buffers()})
    if grads:
        out["grads"] = {n: g.cpu() for n, g in captured.items()}
    ms = []
    for _ in range(steps - 1):
        _sync(device)
        t0 = time.perf_counter()
        m = stage.train_step(state, batch, gen, mesh=mesh)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{case.name}: a later step is not finite: {m}")
    out["ms"] = ms
    out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                       if torch.device(device).type == "cuda" else None)
    return out


def rank_cases(rank: int, device, data: int, model: int, cases, steps: int = 1) -> list[dict]:
    """One spawned rank (`sharding.spawn`): the data x model mesh, then
    `run_case` of each case on it; only rank 0 returns the gradients."""
    mesh = make_device_mesh(data, model)
    return [run_case(c, device, mesh, steps, grads=rank == 0) for c in cases]


# test_torch_skel_train.py's ZERO_GRAD: RootNet's `back_layers.mlp.ln_1.bias`
# and `out.bias` take zero gradient by the softmax cross-entropy's form
ZERO_GRAD = 1e-5


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """|got - ref| / |ref| over all entries (|got - ref| where ref is 0)."""
    got, ref = got.double(), ref.double()
    den = torch.linalg.vector_norm(ref)
    err = torch.linalg.vector_norm(got - ref)
    return float(err / den) if den > 0 else float(err)


def compare(got: dict, ref: dict, zero: float = ZERO_GRAD) -> dict:
    """Each gradient's relative L2 error against the reference's (a
    gradient below `zero` x the step's largest gradient norm, zero by the
    loss's form and rounding noise on both sides, relative to `zero` x
    that norm), the whole vector's (`total`) and the loss's relative error
    (`loss`)."""
    if set(got["grads"]) != set(ref["grads"]):
        raise AssertionError(f"gradients of other parameters: "
                             f"{sorted(set(got['grads']) ^ set(ref['grads']))}")
    names = sorted(ref["grads"])
    norms = {n: float(torch.linalg.vector_norm(ref["grads"][n].double())) for n in names}
    floor = zero * max(norms.values())
    per = {n: float(torch.linalg.vector_norm(got["grads"][n].double() - ref["grads"][n].double()))
           / max(norms[n], floor) if max(norms[n], floor) > 0 else 0.0 for n in names}
    flat = lambda r: torch.cat([r["grads"][n].reshape(-1).double() for n in names])
    a, b = got["metrics"]["total_loss"], ref["metrics"]["total_loss"]
    return dict(per=per, total=rel_l2(flat(got), flat(ref)),
                loss=abs(a - b) / max(abs(b), 1e-30))
