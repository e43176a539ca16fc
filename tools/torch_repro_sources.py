"""Which operations make morig_tpu_torch's training steps differ between two
runs on one NVIDIA GPU.

    PYTHONPATH=<tree> python3 tools/torch_repro_sources.py [--steps 3]

For each of the seven training steps of chip_smoke.py's phases 6 and 9-14
(CorrPoseStage, DeformPoseStage, RigStage jointnet, SkinStage, BoneStage,
RootStage at full width on those phases' batches, and CorrPoseStage in
"batch" norm mode), runs a seeded init and `--steps` steps twice and
compares the losses and every gradient with `torch.equal`.  Each run records
the calls of the operations that could add in a varying order: the edge
backward K6 (`fused_edge_mlp_bwd`), the row scatter of K2's backward
(`scatter_rows`), the backward of the training path's indexed gathers
(`gather_plain` in PointNet++ and the "batch"-mode edge tails) and of every
`torch.gather` whose input takes a gradient, and the forwards K1 and K2.  A
call whose inputs are equal in both runs and whose outputs are not is a
source; the first source in call order is where the runs part.  Prints one
line per stage and a JSON summary.  It imports only what trees older than
the ordered scatter already have (the stages, datasets and kernel
wrappers), so `PYTHONPATH` picks the tree (e.g. a parent unpacked into
`build/parent/`); run it from the repository's root, which holds
chip_smoke.py's batch builders.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())


class Recorder:
    """Calls of the wrapped operations, in order: (op, inputs, outputs)."""

    def __init__(self):
        self.calls: list = []

    def add(self, op, inputs, outputs):
        keep = lambda ts: tuple(t.detach().clone() if torch.is_tensor(t) else t for t in ts)
        self.calls.append((op, keep(inputs), keep(outputs)))


def _grad_recording(op: str, fn, rec: Recorder):
    """fn(x, *rest) whose backward (the same autograd of fn, taken again) is
    recorded with its incoming gradient as input."""

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, *rest):
            ctx.save_for_backward(x)
            ctx.rest = rest
            return fn(x, *rest)

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            with torch.enable_grad():
                xx = x.detach().requires_grad_()
                (gx,) = torch.autograd.grad(fn(xx, *ctx.rest), xx, g)
            rec.add(op, (g, *ctx.rest), (gx,))
            return (gx,) + (None,) * len(ctx.rest)

    def call(x, *rest):
        if torch.is_grad_enabled() and x.requires_grad:
            return Op.apply(x, *rest)
        return fn(x, *rest)

    return call


@contextlib.contextmanager
def recording(rec: Recorder):
    from morig_tpu_torch.kernels import edge_fused, knn_fused
    from morig_tpu_torch.nn import gcu, pointnet

    saved = [(edge_fused, "fused_edge_mlp_bwd"), (edge_fused, "fused_edge_mlp"),
             (knn_fused, "scatter_rows"), (knn_fused, "_knn_gather"),
             (pointnet, "gather_plain"), (gcu, "gather_plain"), (torch, "gather")]
    originals = [getattr(m, n) for m, n in saved]

    def plain(op, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            rec.add(op, args, out if isinstance(out, tuple) else (out,))
            return out
        # the wrapped kernels count their launches on the name they are
        # looked up by, which is now this wrapper
        call.launches = getattr(fn, "launches", 0)
        return call

    edge_fused.fused_edge_mlp_bwd = plain("K6 fused_edge_mlp_bwd", originals[0])
    edge_fused.fused_edge_mlp = plain("K1 fused_edge_mlp", originals[1])
    knn_fused.scatter_rows = plain("scatter_rows (K2 backward)", originals[2])
    knn_fused._knn_gather = plain("K2 _knn_gather", originals[3])
    pointnet.gather_plain = _grad_recording("indexed gather backward (PointNet++)",
                                            originals[4], rec)
    gcu.gather_plain = _grad_recording("indexed gather backward (edge tail)", originals[5], rec)
    tg = originals[6]
    torch.gather = _grad_recording("torch.gather backward",
                                   lambda x, dim, idx: tg(x, dim, idx), rec)
    try:
        yield rec
    finally:
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)


def run(make_stage, batch, steps: int, dev):
    """A seeded init and `steps` steps: (named tensors, recorded calls)."""
    stage = make_stage()
    rec = Recorder()
    named = []
    with recording(rec):
        state = stage.init_state(0, device=dev)
        for s in range(steps):
            m = stage.train_step(state, batch, torch.Generator(device=dev).manual_seed(s))
            named += [(f"step {s} {k}", torch.tensor(v)) for k, v in m.items()]
            named += [(f"step {s} grad {n}", p.grad.detach().clone())
                      for n, p in state.model.named_parameters() if p.grad is not None]
    named += [(f"param {n}", p.detach().clone()) for n, p in state.model.named_parameters()]
    return named, rec.calls


def compare(a, b) -> dict:
    (na, ca), (nb, cb) = a, b
    first = next((n for (n, x), (_, y) in zip(na, nb) if not torch.equal(x, y)), None)
    differing = sorted({n.split(" ", 2)[-1] for (n, x), (_, y) in zip(na, nb)
                        if n.startswith("step") and not torch.equal(x, y)})
    ops: dict = {}
    first_source = None
    for i, ((op, ia, oa), (_, ib, ob)) in enumerate(zip(ca, cb)):
        s = ops.setdefault(op, {"calls": 0, "equal_inputs": 0, "sources": 0})
        s["calls"] += 1
        same_in = all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                      for x, y in zip(ia, ib))
        if not same_in:
            continue
        s["equal_inputs"] += 1
        bad = [k for k, (x, y) in enumerate(zip(oa, ob)) if not torch.equal(x, y)]
        if bad:
            s["sources"] += 1
            if first_source is None:
                first_source = f"call {i}: {op}, outputs {bad}"
    return dict(equal=first is None, first_difference=first, n_differing=len(differing),
                differing=differing[:12], first_source=first_source, ops=ops,
                same_call_count=len(ca) == len(cb))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    import chip_smoke as cs
    from morig_tpu_torch.nn.mlp import set_default_norm
    from morig_tpu_torch.train.stages import (BoneStage, CorrPoseStage, DeformPoseStage, RigStage,
                                              RootStage, SkinStage)

    dev = torch.device("cuda", 0)
    print(f"device: {cs.gpu_name_power()}")
    cs.kb.build()

    def corr():
        stage = CorrPoseStage()
        stage.train_vismask = True
        return stage

    def batch_mode(make):
        def build():
            stage = make()
            init = stage.init_state

            def init_state(seed, device):
                set_default_norm("batch")
                try:
                    return init(seed, device=device)
                finally:
                    set_default_norm("layer")
            stage.init_state = init_state
            return stage
        return build

    pose, rig, skel = cs.train_batch(), cs.rig_batch(), cs.skel_batch()
    stages = [("corr", corr, pose), ("deform", DeformPoseStage, pose),
              ("rig jointnet", lambda: RigStage(arch="jointnet"), rig), ("skin", SkinStage, rig),
              ("bone", BoneStage, skel), ("root", RootStage, skel),
              ("corr batch mode", batch_mode(corr), pose)]
    summary = {}
    for name, make, batch in stages:
        res = compare(run(make, batch, args.steps, dev), run(make, batch, args.steps, dev))
        summary[name] = res
        print(f"{name}: equal {res['equal']}; first difference {res['first_difference']}; "
              f"{res['n_differing']} differing step tensors; first source "
              f"{res['first_source']}; ops {res['ops']}", flush=True)
    print(json.dumps({"repro_sources": summary, "card": cs.gpu_name_power()}))


if __name__ == "__main__":
    main()
