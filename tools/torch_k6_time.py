"""Device time of the training edge layer of morig_tpu_torch on one NVIDIA
GPU — its forward and the backward K6 — at the training path's tables: B=4
capsules (V=1298 padded to 2048), degree-12 tables with neighbour column 1
a copy of column 0 (exact ties in the max), at CorrNet's four edge widths
16, 32, 128 and 256.

    PYTHONPATH=<root> python3 tools/torch_k6_time.py

It times the morig_tpu_torch that sys.path finds (so a parent tree
unpacked from `git archive` is timed with PYTHONPATH pointing at it): per
width, the summed device ms of each of K6's kernels (`fused_edge_mlp_bwd`)
and of the forward kernel that `fused_edge_mlp_trainable` launches (K1's
`edge_mlp_table_kernel`, or on older trees the WMMA `edge_mlp_kernel` K6
recomputed), each under torch.profiler over REPS calls, / REPS, and the
sums over the four widths (K6's kernels include the ordered sum of
db_table, `edge_db_sum_kernel`, on trees that have it).  It makes its own inputs and profiles on its
own, since it must run against packages older than chip_smoke.py's imports
(K6 before its dW2 kernel, whose `sum_parts_kernel` it reads too).  Then,
as a check that the training work leaves serving alone, K1
(`fused_edge_mlp`) and K5 (`fused_edge_mlp_windowed`, tile 128) at
chip_smoke.py's serving tables (B*T=20 capsules, V=1298 padded to 1536,
degree 12) over the five edge widths, with their sums.
"""
from __future__ import annotations

import math
import subprocess
import sys
import time
from pathlib import Path

import torch

REPS = 20
WIDTHS = (16, 32, 128, 256)
NAMES = ("edge_mlp_bwd_kernel", "edge_mlp_dw2_kernel", "sum_parts_kernel", "edge_db_sum_kernel")
FORWARD_NAMES = ("edge_mlp_table_kernel<", "edge_mlp_kernel<")   # K1; the older WMMA kernel


def training_tables(dev):
    from morig_tpu_torch.data.pose import PoseDataset, capsule_pose_dataset

    ds = capsule_pose_dataset(num_models=4, num_frames=4, num_points=1024, n_lat=37, n_lon=36)
    ds = PoseDataset(ds.models, tpl_max_degree=12, geo_max_degree=12)
    mesh = ds.batch(list(range(4)), 0, 2, device=dev).mesh
    nbr, mask = mesh.tpl_nbr.clone(), mesh.tpl_mask.clone()
    nbr[:, :, 1], mask[:, :, 1] = nbr[:, :, 0], mask[:, :, 0]
    return nbr, mask


def k6_inputs(dev, nbr, mask, H, seed):
    """chip_smoke.py's K6 inputs: bf16 a, b; W2 / sqrt(H); LN scales in
    [0.5, 1.5); seeded dout."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, V, _ = nbr.shape
    a = torch.randn(B, V, H, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(B, V, H, device=dev, generator=g).to(torch.bfloat16)
    w2 = torch.randn(H, H, device=dev, generator=g) / math.sqrt(H)
    vecs = [0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g)]
    dout = torch.randn(B, V, H, device=dev, generator=g)
    return (a, b, nbr, mask, w2, *vecs), dout


def device_ms(fn, names=NAMES) -> dict:
    """Device ms per call of each kernel named (a substring of its device
    ops' names): the summed durations of its ops under torch.profiler over
    REPS calls, / REPS (taken again, up to three times, unless the ops of
    the names ran exactly REPS times for the first name that ran)."""
    from torch.autograd import DeviceType
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
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out = {n: sum(e.time_range.elapsed_us() for e in ev if n in e.name) / 1e3 / REPS
               for n in names}
        counts = [sum(n in e.name for e in ev) for n in names]
        if next((c for c in counts if c), 0) == REPS:
            return {n: t for n, t, c in zip(names, out.values(), counts) if c}
    raise RuntimeError(f"the profiler lost the device ops of {names} three times")


def serving_tables(dev):
    from morig_tpu_torch.core.batch import stack_meshes
    from morig_tpu_torch.data.synthetic import capsule_batch

    entries, _ = capsule_batch(4, 5, 1024, 1536, 12)
    mesh = stack_meshes([e for e in entries for _ in range(5)], dev)
    return mesh.tpl_nbr, mesh.tpl_mask


def time_serving(dev) -> None:
    from morig_tpu_torch.kernels.edge_fused import fused_edge_mlp, fused_edge_mlp_windowed

    nbr, mask = serving_tables(dev)
    totals = {"K1": 0.0, "K5": 0.0}
    for H in (16, 32, 64, 128, 256):
        args, _ = k6_inputs(dev, nbr, mask, H, seed=H + 1)
        k1 = device_ms(lambda: fused_edge_mlp(*args), ("edge_mlp_table_kernel<",))
        k5 = device_ms(lambda: fused_edge_mlp_windowed(*args, tile_v=128),
                       ("edge_mlp_windowed_kernel<",))
        totals["K1"] += sum(k1.values())
        totals["K5"] += sum(k5.values())
        print(f"serving H={H}: device K1 {sum(k1.values()):.4f} ms, K5 {sum(k5.values()):.4f} ms")
    print(f"serving over the five widths: device K1 {totals['K1']:.4f} ms, K5 {totals['K5']:.4f} ms")


def time_package(dev) -> None:
    import morig_tpu_torch
    from morig_tpu_torch.kernels.build import library
    from morig_tpu_torch.kernels.edge_fused import fused_edge_mlp_bwd, fused_edge_mlp_trainable

    library()
    print(f"package: {Path(morig_tpu_torch.__file__).resolve().parent}")
    nbr, mask = training_tables(dev)
    total = total_fwd = 0.0
    for H in WIDTHS:
        args, dout = k6_inputs(dev, nbr, mask, H, seed=H)
        with torch.no_grad():
            fwd = device_ms(lambda: fused_edge_mlp_trainable(*args), FORWARD_NAMES)
        ms = device_ms(lambda: fused_edge_mlp_bwd(*args, dout))
        total += sum(ms.values())
        total_fwd += sum(fwd.values())
        print(f"forward H={H}: device " + ", ".join(f"{n.rstrip('<')} {t:.4f}"
                                                    for n, t in fwd.items()) + " ms")
        print(f"K6 H={H}: device {sum(ms.values()):.4f} ms ("
              + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()) + ")")
    print(f"forward over the four widths: device {total_fwd:.4f} ms")
    print(f"K6 over the four widths: device {total:.4f} ms")
    time_serving(dev)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_k6_time.py needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"device: {card}")
    time_package(dev)


if __name__ == "__main__":
    main()
