"""Device time of the row-invariant fp32 product KG of morig_tpu_torch
(`kernels.gemm.gemm`) on one NVIDIA GPU, beside one `torch.matmul` (cuBLAS)
on the same inputs, at chip_smoke.py's phase-3 shapes (`KG_SHAPES`: the
training step's Dense layers over 8192 and 120 rows, a global MLP over 4
rows, the jointnet loss's masked mean) and at the input gradients' n-fast
shapes (dy @ W of the two 8192-row layers).

    PYTHONPATH=<root> python3 tools/torch_kg_time.py [--routes]

It times the morig_tpu_torch that sys.path finds, so a parent tree
unpacked from `git archive` is timed with PYTHONPATH pointing at it.  Per
shape: the summed durations of the device ops whose names hold `gemm_f32_`
under torch.profiler over REPS calls, / REPS (where three traces each lost
or split ops, their mean duration times the ops a call launches), and the
same for every device op of torch.matmul; then the sums over the phase-3
shapes.  With --routes
(trees whose `gemm` takes `route` and `tile`), each shape also through every
route and tile its planner can be forced to, each output held equal to the
planned call's bit for bit.  Prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import math
import subprocess
import time

import torch

REPS = 20
# (batch, M, K, N, bias), as chip_smoke.py KG_SHAPES
KG_SHAPES = ((None, 8192, 512, 512, True), (None, 8192, 288, 256, True),
             (None, 120, 256, 128, True), (None, 120, 768, 256, True),
             (None, 4, 1088, 1024, True), (4, 1, 1024, 1, False))
# dx = dy @ W of the two 8192-row layers: (M, K, N), b n-fast
N_FAST_SHAPES = ((8192, 512, 512), (8192, 256, 288))


def device_ms(fn, name=None) -> float:
    """Summed durations of fn's device ops (those whose name holds `name`)
    per call, under torch.profiler over REPS calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation and (name is None or name in e.name)]
        if ops and len(ops) % REPS == 0:
            return sum(e.time_range.elapsed_us() for e in ops) / 1e3 / REPS
    if len(ops) < REPS // 2:
        raise RuntimeError(f"profiler: {len(ops)} device ops named {name!r} in {REPS} calls")
    # the trace lost or split a few ops: their mean, times the ops a call launches
    per_call = max(1, round(len(ops) / REPS))
    return sum(e.time_range.elapsed_us() for e in ops) / 1e3 / len(ops) * per_call


def inputs(dev, batch, M, K, N, with_bias, n_fast, g):
    lead = () if batch is None else (batch,)
    a = torch.randn(lead + (M, K), device=dev, generator=g)
    if n_fast:
        b = torch.randn(lead + (K, N), device=dev, generator=g) / math.sqrt(K)
    else:
        b = (torch.randn(lead + (N, K), device=dev, generator=g) / math.sqrt(K)).transpose(-1, -2)
    bias = torch.randn(N, device=dev, generator=g) if with_bias else None
    return a, b, bias


def main(routes: bool) -> None:
    from morig_tpu_torch.kernels import build as kb
    from morig_tpu_torch.kernels import gemm as kg

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}; torch {torch.__version__}; package {kg.__file__}")
    kb.library()
    forceable = "route" in inspect.signature(kg.gemm).parameters
    g = torch.Generator(device=dev).manual_seed(22)
    total_k = total_l = 0.0
    cases = [(s, False) for s in KG_SHAPES] + [((None, M, K, N, False), True)
                                               for M, K, N in N_FAST_SHAPES]
    for (batch, M, K, N, with_bias), n_fast in cases:
        a, b, bias = inputs(dev, batch, M, K, N, with_bias, n_fast, g)
        t_k = device_ms(lambda: kg.gemm(a, b, bias), "gemm_f32_")
        t_l = device_ms(lambda: kg.gemm_plain(a, b, bias))
        if not n_fast:
            total_k, total_l = total_k + t_k, total_l + t_l
        lead = () if batch is None else (batch,)
        desc = (f"{lead + (M, K)} x {lead + (K, N)}{' + bias' if with_bias else ''}"
                f"{' (b n-fast)' if n_fast else ''}")
        p = (kg.plan(batch or 1, M, N, K, kg.sm_count(dev)) if forceable else None)
        print(f"KG {desc}: device {t_k:.4f} ms, torch.matmul {t_l:.4f} ms "
              f"(x{t_k / t_l:.2f}){'; plan ' + str(p) if p else ''}")
        if routes and forceable:
            ref = kg.gemm(a, b, bias)
            for route in kg.ROUTES:
                if route == "tiny" and M * N > 1 << 16:
                    continue                  # one thread per element: seconds at 8192 rows
                for tile in ([None] if route == "tiny" else range(len(kg.TILES))):
                    fn = lambda: kg.gemm(a, b, bias, route=route, tile=tile)  # noqa: E731
                    same = torch.equal(fn(), ref)
                    print(f"  forced {route} tile {tile}: device "
                          f"{device_ms(fn, 'gemm_f32_'):.4f} ms, equal bits {same}")
    print(f"KG over the {len(KG_SHAPES)} phase-3 shapes: device {total_k:.4f} ms, "
          f"torch.matmul {total_l:.4f} ms; {card}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--routes", action="store_true",
                        help="also time every forced route and tile, checked bit for bit")
    main(parser.parse_args().routes)
