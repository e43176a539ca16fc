"""The replayed training steps of chip_smoke.py's phase 20 on one NVIDIA GPU:
for each of its cases (corr, corr through K5, rig jointnet, bone) and two of
this tool's (deform: DeformPoseStage, its extractor frozen, on phase 6's
capsules; skin: SkinStage on phase 10's creatures), one eager train step
against one replay of the captured step, each from fresh seeded weights,
with its CUDA-event median ms, device ops, busy ms and idle share
(`chip_smoke.profile_scan_case`, what `chip_smoke.py --profile` prints in
phase 20), without the rest of the smoke run.

    PYTHONPATH=<root> python3 tools/torch_replay_time.py [--kernels] [--cases corr,skin]

With --kernels, also per case: one replay under torch.profiler, its device
time by kernel (the largest first); and the products the captured step
hands the row-invariant product KG (`kernels.gemm.gemm`, recorded while the
step is captured: shapes, strides, bias), each timed alone as KG and as one
torch.matmul (cuBLAS) on tensors of the same shapes and strides, times its
calls per step.

It imports the chip_smoke.py and the morig_tpu_torch that sys.path finds,
so a parent tree unpacked from `git archive` is timed with PYTHONPATH
pointing at it, and two trees compare in one call on one card.
"""
from __future__ import annotations

import argparse
import collections
import re
import time

import torch

from torch_kg_time import device_ms

TOP = 12


def short(name: str) -> str:
    """A device op's name without its return type, namespace, template
    arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0][:70]


def kernel_split(cs, case, dev) -> None:
    """One replay of the case's captured train step by kernel, and the KG
    products it captured, each timed alone."""
    from torch.profiler import ProfilerActivity, profile

    from morig_tpu_torch.kernels import gemm as kg

    calls = collections.Counter()
    gemm = kg.gemm

    def recorded(a, b, bias=None, **kw):
        calls[(tuple(a.shape), a.stride(), tuple(b.shape), b.stride(), bias is not None)] += 1
        return gemm(a, b, bias, **kw)

    stage = case.make()
    stage.on_epoch(case.epochs)
    state = cs.full_width_state(f"scanned {case.name}", stage)
    recorded.launches = gemm.launches         # the wrapper counts through its module's name
    kg.gemm = recorded
    try:
        fn = cs.step_program(stage, state, case.batcher, torch.Generator(device=dev).manual_seed(1))
    finally:
        kg.gemm = gemm
        gemm.launches = recorded.launches
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = collections.defaultdict(lambda: [0.0, 0])
    for e in cs.device_events(prof):
        by[short(e.name)][0] += e.time_range.elapsed_us() / 1e3
        by[short(e.name)][1] += 1
    busy = sum(v[0] for v in by.values())
    print(f"kernels of one replayed {case.name} step (busy {busy:.2f} ms): " + "; ".join(
        f"{k} {v[0]:.3f} ms x{v[1]}" for k, v in sorted(by.items(), key=lambda kv: -kv[1][0])[:TOP]))
    rows, g = [], torch.Generator(device=dev).manual_seed(0)

    def like(shape, stride):
        """Random values in the recorded layout (contiguous where it
        overlaps itself)."""
        t = torch.randn(shape, device=dev, generator=g)
        if 0 in stride:
            return t
        return torch.empty_strided(shape, stride, device=dev).copy_(t)

    for (ash, ast, bsh, bst, has_bias), n in calls.items():
        a, b = like(ash, ast), like(bsh, bst)
        bias = torch.randn(bsh[-1], device=dev, generator=g) if has_bias else None
        t_k = device_ms(lambda: gemm(a, b, bias), "gemm_f32_")
        t_l = device_ms(lambda: kg.gemm_plain(a, b, bias))
        rows.append((n * t_k, n * t_l, n, ash, bsh, bst, has_bias, t_k, t_l))
    tot_k, tot_l = sum(r[0] for r in rows), sum(r[1] for r in rows)
    print(f"KG in one {case.name} step: {sum(calls.values())} calls, {len(calls)} shapes; alone "
          f"{tot_k:.3f} ms as KG, {tot_l:.3f} ms as torch.matmul")
    for tk, tl, n, ash, bsh, bst, has_bias, t_k, t_l in sorted(rows, key=lambda r: -r[0])[:TOP]:
        print(f"  {n} x {ash} @ {bsh} (b strides {bst}){' + bias' if has_bias else ''}: "
              f"KG {t_k:.4f} ms ({tk:.3f} per step), torch.matmul {t_l:.4f} ms ({tl:.3f})")


def more_cases(cs, rig_ds) -> list:
    """The deform and skin cases, on phase 6's and phase 10's data (batch 4,
    4 epochs in chunks of 2; the launches are not held here)."""
    from morig_tpu_torch.train.scanned import pose_scan_batcher, rig_scan_batcher
    from morig_tpu_torch.train.stages import DeformPoseStage, SkinStage

    ds = cs.train_dataset()
    return [cs.ScanCase("deform", DeformPoseStage,
                        lambda rng, train: ds.epoch_batches(rng, cs.TRAIN_B, "modelsresource",
                                                            False, train),
                        pose_scan_batcher(ds, cs.TRAIN_B, "modelsresource", False), 4, 2, {}),
            cs.ScanCase("skin", SkinStage,
                        lambda rng, train: rig_ds.epoch_batches(rng, cs.TRAIN_B, train),
                        rig_scan_batcher(rig_ds, cs.TRAIN_B), 4, 2, {})]


def main(kernels: bool, names=None) -> None:
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"device: {cs.gpu_name_power()}; torch {torch.__version__}; {cs.__file__}")
    cs.kb.library()
    t0 = time.perf_counter()
    rig_ds = cs.creature_rig_dataset(num_models=cs.TRAIN_B, seed=0)
    for case in cs.scan_cases(rig_ds, cs.skel_batch()) + more_cases(cs, rig_ds):
        if names and case.name not in names:
            continue
        cs.profile_scan_case(case, dev)
        if kernels:
            kernel_split(cs, case, dev)
    print(f"replayed steps: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", action="store_true",
                        help="also each replayed step by kernel, and its KG products timed alone")
    parser.add_argument("--cases", default=None,
                        help="comma-separated case names (default: all six)")
    a = parser.parse_args()
    main(a.kernels, a.cases.split(",") if a.cases else None)
