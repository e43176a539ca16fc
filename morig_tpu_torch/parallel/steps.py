"""A training stage's step on a mesh and on one device, and what it computed
— the steps the CPU tests and chip_smoke.py's phase 19 hold against each
other (the counterpart of the JAX package's dp/tp parity tests' steps).

A `StepCase` says how to build the stage, its state and the global batch;
`run_case` runs it on one device or as one rank of a mesh and returns the
first step's metrics, its gradients as the optimizer received them (summed
over the data group, before the clip; a sharded layer's gathered whole)
and the buffers after it (the "batch" mode's running statistics).
`rank_cases` is `run_case` for each case, as one spawned rank.

`split_sources` finds where a sharded step's rows part from the one-device
step's: every rank's first step and the one-device step run under a
`CallRecorder`, and `split_differences` names the first call whose inputs
equal the one-device call's (the rank's rows of them) bit for bit and whose
output does not.  Weight gradients are sums over the rows and are not
compared.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import sys
import time
import weakref
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
    the first step runs inside, called with the state (chip_smoke's kernel
    recorders, `CallRecorder`).  Returns
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
        with on_first(state):
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


# ---------------------------------------------------------------------------
# where a rank's rows part from the one-device step's
# ---------------------------------------------------------------------------

# aten operations that move or cast data and compute nothing: they cannot
# make a rank's rows differ from the one-device step's, and their outputs
# (a flattened axis, a permuted one) need not keep the batch on an axis
# the comparison can slice; allocations hold no values yet.
MOVES = frozenset("""
    _reshape_alias _to_copy _unsafe_view alias as_strided cat chunk clone contiguous copy_
    detach expand expand_as flatten gather index index_put_ index_select lift_fresh masked_select
    narrow new_zeros new_ones ones ones_like permute repeat reshape select slice split
    split_with_sizes squeeze stack t transpose unbind unflatten unsqueeze view view_as zeros
    zeros_like zero_ fill_ full full_like arange
    empty empty_like empty_strided new_empty new_empty_strided _local_scalar_dense
""".split())
# the wrappers that launch the port's kernels (K1, K5, K6, K2, K4, K3, KS,
# KG): their launches are no aten operation, so each call is recorded whole
KERNEL_CALLS = (("kernels.edge_fused", "fused_edge_mlp"),
                ("kernels.edge_fused", "fused_edge_mlp_windowed"),
                ("kernels.edge_fused", "fused_edge_mlp_bwd"),
                ("kernels.knn_fused", "_knn_gather"), ("kernels.knn_fused", "knn_topk"),
                ("kernels.gather_fused", "gather_rows"), ("kernels.gather_fused", "scatter_rows"),
                ("kernels.gemm", "gemm"))
_SITE = "split_site"
_GOLDEN = 0x9E3779B97F4A7C15 - 2**64       # splitmix64's increment, as an int64
_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_PKG = "morig_tpu_torch" + __import__("os").sep


def _tensors(obj) -> list:
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _codes(n: int, axis: int, device) -> torch.Tensor:
    """A mixed int64 code of each index 0..n-1 on `axis` (splitmix64's
    steps, wrapping): even on the three axes a rank's rows may lie on, odd
    on the flattened rest, so each element's weight (their sum) is odd."""
    offset = ((axis + 1) * _GOLDEN + 2**63) % 2**64 - 2**63
    z = torch.arange(n, dtype=torch.int64, device=device) + offset
    z = z * -4658895280553007687              # 0xbf58476d1ce4e5b9
    z = z ^ (z >> 27)
    z = z * -7723592293110705685              # 0x94d049bb133111eb
    z = z ^ (z >> 31)
    return z * 2 + (axis == 3)


class _Weights:
    """Each element's weight, the sum of its four indices' codes (its
    first three axes and the flat rest), so that a slice from 0 along one
    of the first three axes keeps every element's weight."""

    def __init__(self):
        self.codes: dict = {}

    def code(self, axis: int, n: int, device) -> torch.Tensor:
        c = self.codes.get((device, axis))
        if c is None or c.numel() < n:
            c = self.codes[(device, axis)] = _codes(
                max(n, 1024, 2 * (0 if c is None else c.numel())), axis, device)
        return c[:n]

    def __call__(self, shape4: tuple, device) -> torch.Tensor:
        w = None
        for axis, n in enumerate(shape4):
            c = self.code(axis, n, device).view([n if a == axis else 1 for a in range(4)])
            w = c if w is None else w + c
        return w


class CallRecorder:
    """Records every aten operation a step runs that computes (`MOVES` left
    out) and every kernel wrapper call (`KERNEL_CALLS`), in call order, in
    the forward and the backward: its name, where it was called (the
    innermost frame of this package and the innermost module of `model`;
    in the backward, those of the forward call that made the autograd
    node) and a digest of each input and output (sum_i bits_i * w_i in
    int64, equal for tensors equal bit for bit).  With `parts` > 1 also
    each tensor's digests of its `parts` equal slices along each of its
    first three axes (each data index's rows of the whole batch's
    tensor)."""

    def __init__(self, model: Optional[torch.nn.Module] = None, parts: int = 1):
        from torch.overrides import TorchFunctionMode
        from torch.utils._python_dispatch import TorchDispatchMode

        self.parts, self.calls, self.digests = parts, [], []
        self.names = {id(m): n or "model" for n, m in (model.named_modules() if model else [])}
        self.modules: list = []
        self.entered: list = []
        self.weights = _Weights()
        self.seen: dict = {}
        self.known: dict = {}
        self.busy = False          # digesting: the digests' own operations are not recorded
        rec = self

        class Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if (rec.busy or func.namespace != "aten"
                        or func.overloadpacket.__name__ in MOVES):
                    return func(*args, **kwargs)
                ins = rec.digest(_tensors((args, kwargs)))
                out = func(*args, **kwargs)
                rec.add(func.overloadpacket.__name__, ins, rec.digest(_tensors(out)))
                return out

        class Sites(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if rec.busy:
                    return out
                nodes, where = [t.grad_fn for t in _tensors(out)], None
                while nodes:               # the nodes this call made (e.g. matmul's mm)
                    node = nodes.pop()
                    if node is None or _SITE in node.metadata:
                        continue
                    node.metadata[_SITE] = where = where or rec.where()
                    nodes += [f for f, _ in node.next_functions]
                return out

        self.modes = (Sites(), Ops())

    def where(self) -> tuple[str, str]:
        """(file:line function, module) of the call being made."""
        f = sys._getframe(1)
        while f is not None and (_PKG not in f.f_code.co_filename
                                 or f.f_code.co_filename.endswith("steps.py")):
            f = f.f_back
        site = "?" if f is None else (f"{f.f_code.co_filename.rsplit(_PKG, 1)[1]}:{f.f_lineno} "
                                      f"{f.f_code.co_name}")
        return site, self.modules[-1] if self.modules else "-"

    def digest(self, tensors: list) -> list:
        """(shape, index of the whole digest, the index of each part's
        digest along each axis (the first index; the parts follow) or
        None) of each tensor; a tensor digested before and not changed
        since keeps its digests."""
        out, busy, self.busy = [], self.busy, True
        for t in tensors:
            known = self.known.get(id(t))
            if known is not None and known[0]() is t and known[1] == t._version:
                out.append(known[2])
                continue
            entry = self._digest(t)
            key = id(t)
            self.known[key] = (weakref.ref(t, lambda _, k=key: self.known.pop(k, None)),
                               t._version, entry)
            out.append(entry)
        self.busy = busy
        return out

    def _digest(self, t: torch.Tensor) -> tuple:
        shape = tuple(t.shape)
        t = t.detach()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if t.is_floating_point():
            t = t.contiguous().view(_INT[t.element_size()])
        dims = (list(shape[:3]) + [1] * 3)[:3]
        shape4 = tuple(dims) + (t.numel() // max(1, dims[0] * dims[1] * dims[2]),)
        bits = t.reshape(shape4).to(torch.int64)
        prod = bits * self.weights(shape4, t.device)
        sums = [prod.sum()]
        parts = [None] * min(len(shape), 3)
        for k in range(len(parts)):
            if self.parts > 1 and shape[k] % self.parts == 0 and shape[k]:
                parts[k] = len(self.digests) + len(sums)
                n = shape[k] // self.parts
                # part i's digest as a tensor of its own, whose indices on
                # axis k start at 0: its elements' axis-k codes moved from
                # code[i n + j] to code[j], through the sums of bits at each
                # index of axis k
                per = bits.sum([a for a in range(4) if a != k])
                code = self.weights.code(k, shape[k], t.device)
                sums += [prod.narrow(k, i * n, n).sum()
                         - (per[i * n:(i + 1) * n] * (code[i * n:(i + 1) * n] - code[:n])).sum()
                         for i in range(self.parts)]
        self.digests += sums
        return shape, len(self.digests) - len(sums), parts

    def add(self, name: str, ins: list, outs: list, where=None, start=None) -> None:
        """A call's record; `start`, for a module's, is the index of the
        first call made inside it."""
        node = torch._C._current_autograd_node()
        site = node.metadata.get(_SITE) if node is not None else None
        where = site or where or self.where()
        phase = "forward" if node is None else "backward"
        key = (phase, name) + tuple(where)
        n = self.seen[key] = self.seen.get(key, -1) + 1
        self.calls.append((key, n, ins, outs, start))

    def kernel(self, fn, label: str):
        rec = self

        class Call:
            def __call__(self, *args, **kw):
                ins = rec.digest(_tensors((args, kw)))
                where = rec.where()
                out = fn(*args, **kw)
                rec.add(label, ins, rec.digest(_tensors(out)), where)
                return out

            launches = property(lambda self: fn.launches,
                                lambda self, n: setattr(fn, "launches", n))

        return Call()

    @contextlib.contextmanager
    def __call__(self):
        from torch.nn.modules import module as module_hooks

        swapped = []
        for modname, attr in KERNEL_CALLS:
            fn = getattr(sys.modules[f"morig_tpu_torch.{modname}"], attr)
            wrapped = self.kernel(fn, f"kernel {attr}")
            for mod in [m for n, m in list(sys.modules.items())
                        if n.startswith("morig_tpu_torch") and getattr(m, attr, None) is fn]:
                setattr(mod, attr, wrapped)
                swapped.append((mod, attr, fn))
        def enter(module, args):
            self.modules.append(self.names.get(id(module), type(module).__name__))
            self.entered.append((len(self.calls), self.digest(_tensors(args))))

        def leave(module, args, out):
            start, ins = self.entered.pop()
            code = type(module).forward.__code__
            where = (f"{code.co_filename.rsplit(_PKG, 1)[-1]}:{code.co_firstlineno} "
                     f"{type(module).__name__}.forward", self.modules.pop())
            self.add(f"module {type(module).__name__}", ins, self.digest(_tensors(out)),
                     where, start)

        pre = module_hooks.register_module_forward_pre_hook(enter)
        post = module_hooks.register_module_forward_hook(leave)
        try:
            with self.modes[0], self.modes[1]:
                yield self
        finally:
            pre.remove()
            post.remove()
            for mod, attr, fn in swapped:
                setattr(mod, attr, fn)

    def result(self) -> dict:
        """The calls and their digests (CPU), to send between processes."""
        d = (torch.stack(self.digests).cpu() if self.digests
             else torch.zeros(0, dtype=torch.int64))
        return {"calls": self.calls, "digests": d}


def record_case(case: StepCase, device, mesh=None, parts: int = 1) -> dict:
    """The first train step of `case` (as `run_case`), its forward and
    backward recorded by a `CallRecorder` (the optimizer's update not)."""
    recs = []

    def on_first(state):
        rec = CallRecorder(state.model, parts)
        recs.append(rec)
        step = state.tx.step

        def update(m=None):                # the clip and Adam come after the gradients
            rec.busy = True
            try:
                return step(m)
            finally:
                rec.busy = False

        state.tx.step = update
        return rec()

    run_case(case, device, mesh, 1, grads=False, on_first=on_first)
    return recs[0].result()


def split_rank(rank: int, device, data: int, model: int, cases) -> list:
    """One spawned rank of `split_sources`: each case's first step on the
    data x model mesh, recorded, with the rank and its data index."""
    mesh = make_device_mesh(data, model)
    return [dict(record_case(case, device, mesh), rank=rank, data_index=mesh.data_index)
            for case in cases]


def _same(r, o, dr, do, data: int, index: int, output: bool) -> Optional[bool]:
    """Whether a rank's tensor (shape, digest, parts) equals its rows (those
    of data index `index`) of
    the one-device tensor; None where they cannot be compared: shapes that
    differ otherwise than by the rows of one of the first three axes, and
    at data > 1 an output with no batch axis (a sum over the rows, as a
    weight gradient)."""
    (rs, ri, _), (os_, oi, oparts) = r, o
    if rs == os_:
        if output and data > 1:
            return None
        return bool(dr[ri] == do[oi])
    diff = [k for k, (a, b) in enumerate(zip(rs, os_)) if a != b]
    if (data == 1 or len(rs) != len(os_) or len(diff) != 1 or diff[0] >= len(oparts)
            or rs[diff[0]] * data != os_[diff[0]] or oparts[diff[0]] is None):
        return None
    return bool(dr[ri] == do[oparts[diff[0]] + index])


def split_differences(rank: dict, one: dict, data: int) -> dict:
    """A rank's recorded calls (`split_rank`) against the one-device step's
    (`record_case` with parts = data), each matched to the call of the same
    phase, name, site and module and the same occurrence.  A source is a
    call whose inputs equal the one-device call's (the rank's rows of them)
    bit for bit and whose output does not; a module call is one only where
    no call inside it is (the innermost).  Returns the `rank`, `first` (the
    first source in the rank's call order, None where there is none),
    `sources` (each distinct source, in order, with its count),
    `first_output` (the first call whose output differs), and the counts
    of calls (`phases`: forward and backward), matched and compared."""
    dr, do, di = rank["digests"].numpy(), one["digests"].numpy(), rank["data_index"]
    index = {(key, n): (ins, outs) for key, n, ins, outs, _ in one["calls"]}
    sources: dict = {}
    first_output, matched, compared, last = None, 0, 0, -1
    phases = {"forward": 0, "backward": 0}
    for i, (key, n, ins, outs, start) in enumerate(rank["calls"]):
        phases[key[0]] += 1
        ref = index.get((key, n))
        if ref is None or len(ref[0]) != len(ins) or len(ref[1]) != len(outs):
            continue
        matched += 1
        same_in = [_same(r, o, dr, do, data, di, False) for r, o in zip(ins, ref[0])]
        same_out = [_same(r, o, dr, do, data, di, True) for r, o in zip(outs, ref[1])]
        if not any(s is not None for s in same_out):
            continue
        compared += 1
        if False in same_out:
            call = {"phase": key[0], "call": key[1], "site": key[2], "module": key[3],
                    "index": i, "inputs equal": all(x is True for x in same_in),
                    "shapes": [r[0] for r in outs]}
            first_output = first_output or call
            if call["inputs equal"] and (start is None or last < start):
                last = i
                s = sources.setdefault(key, dict(call, count=0))
                s["count"] += 1
    ordered = sorted(sources.values(), key=lambda s: s["index"])
    return {"rank": rank["rank"], "first": ordered[0] if ordered else None, "sources": ordered,
            "first_output": first_output, "calls": len(rank["calls"]), "phases": phases,
            "matched": matched, "compared": compared}


def split_result(ranks: list, one: dict, data: int) -> dict:
    """Every rank's records of one case against the one-device step's: the
    `split_differences` of the first rank (in rank order) with a source,
    else rank 0's."""
    diffs = [split_differences(r, one, data) for r in ranks]
    return next((d for d in diffs if d["first"] is not None), diffs[0])


def split_sources(cases, device, data: int = 2, model: int = 1, backend: str = "gloo",
                  devices=None, threads: Optional[int] = None) -> list[dict]:
    """For each case, every rank of a data x model mesh (spawned over
    `backend` on `devices`, all on `device` when None) against the
    one-device step on the global batch, call by call (`split_result`)."""
    from morig_tpu_torch.parallel.sharding import spawn

    ones = [record_case(c, device, None, parts=data) for c in cases]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ranks = spawn(split_rank, data * model, backend, devices or [str(device)],
                  args=(data, model, list(cases)), threads=threads)
    return [split_result([r[i] for r in ranks], one, data) for i, one in enumerate(ones)]


def describe(diff: dict) -> str:
    """One line naming a `split_differences` result's first source."""
    s = diff["first"]
    head = (f"rank {diff['rank']}: {diff['calls']} calls, {diff['matched']} matched, "
            f"{diff['compared']} compared; ")
    if s is None:
        fo = diff["first_output"]
        return head + ("no call differs" if fo is None else
                       f"no source; first differing output: {fo['phase']} {fo['call']} at "
                       f"{fo['site']} ({fo['module']})")
    return head + (f"first source: {s['phase']} {s['call']} at {s['site']} ({s['module']}), "
                   f"output {s['shapes']}; {len(diff['sources'])} distinct sources: "
                   + "; ".join(f"{x['phase']} {x['call']} {x['site']} x{x['count']}"
                               for x in diff["sources"][:8]))
