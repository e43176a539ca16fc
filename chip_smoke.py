"""Smoke run of the PyTorch/CUDA port (morig_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # what the smoke check runs
    python3 chip_smoke.py --profile   # plus phase 5

Phases, each printing its own lines:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — compiles the kernels from csrc/ with nvcc (sm_90a);
  3. kernels — each of K1 (edge MLP), K2 (kNN + gather), K3 (row gather)
               against its plain PyTorch version on the card, at the shapes
               the main path gives it, with errors, tolerances and
               CUDA-event median times;
  4. main path — `RigPredictor.predict_rig_batch` on B=4 capsule meshes
               (V=1262 padded to 1536, degree-12 tables, P=1024, T=5) with
               seeded random weights (heads included): one warm-up call,
               then 7 timed calls, each checked; checks that the first
               timed call launched every kernel the expected number of
               times; prints the call's median and quartiles, meshes/s,
               per-phase medians and peak device memory;
  5. profile (--profile only) — each device program's CUDA-event time,
               its device ops and busy time under torch.profiler, the
               ported kernels' share, and CUDA-event times of FPS and the
               clustering.
Then a JSON line of kernel results, the card's name and power limit, and
last `{"ok": true, "device": {...}}`.  Any failure raises: the exit code is
non-zero and the last line is not printed.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from morig_tpu_torch.core.batch import stack_meshes
from morig_tpu_torch.data.synthetic import capsule_batch
from morig_tpu_torch.kernels import build as kb
from morig_tpu_torch.kernels.edge_fused import edge_mlp_plain, fused_edge_mlp
from morig_tpu_torch.kernels.gather_fused import gather_plain, gather_rows
from morig_tpu_torch.kernels.knn_fused import NEG, knn_batched, knn_plain
from morig_tpu_torch.nn.corrnet import l2_normalize
from morig_tpu_torch.nn.gcu import EdgeMLP
from morig_tpu_torch.pipelines.rig_predict import RigPredictor

B_MESH, T, P, V_PAD, DEGREE = 4, 5, 1024, 1536, 12
# K1: the kernel and the plain version round LN1 outputs (|h| up to ~6) to
# bf16 from fp32 values that differ in the last bits, so a rare element
# lands one bf16 ulp (2^-8 relative) apart; through W2 and LN2 that moves
# an O(1) output by up to ~2e-2.  The mean error stays at fp32 level
# (below 7e-7 at every width on the H100), so it is held to 1e-5.
K1_TOL, K1_MEAN_TOL = 3e-2, 1e-5
K2_TOL = 1e-5     # fp32 sums of exact bf16 products, in another order
REPS = 10         # CUDA-event samples per kernel timing
MAIN_REPS = 7     # timed calls of predict_rig_batch after the warm-up


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_k1(dev, mesh_bt):
    """Every edge width of the slice, over the B*T tables of the flow program."""
    g = torch.Generator(device=dev).manual_seed(1)
    Bt, V, D = mesh_bt.tpl_nbr.shape
    err = ms = plain_ms = 0.0
    for H in (16, 32, 64, 128, 256):
        a = torch.randn(Bt, V, H, device=dev, generator=g).to(torch.bfloat16)
        b = torch.randn(Bt, V, H, device=dev, generator=g).to(torch.bfloat16)
        w2 = torch.randn(H, H, device=dev, generator=g) / math.sqrt(H)
        vecs = [0.1 * torch.randn(H, device=dev, generator=g),
                torch.rand(H, device=dev, generator=g) + 0.5,
                0.1 * torch.randn(H, device=dev, generator=g),
                torch.rand(H, device=dev, generator=g) + 0.5,
                0.1 * torch.randn(H, device=dev, generator=g)]
        args = (a, b, mesh_bt.tpl_nbr, mesh_bt.tpl_mask, w2, *vecs)
        got = fused_edge_mlp(*args)
        ref = edge_mlp_plain(*args)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        e_mean = (got - ref).abs().mean().item()
        t_k = median_ms(lambda: fused_edge_mlp(*args))
        t_p = median_ms(lambda: edge_mlp_plain(*args))
        print(f"K1 edge_mlp B={Bt} V={V} D={D} H={H}: max_abs_err {e:.3g} (tol {K1_TOL}), "
              f"mean {e_mean:.3g} (tol {K1_MEAN_TOL}); kernel {t_k:.4f} ms plain {t_p:.4f} ms")
        if not (e <= K1_TOL and e_mean <= K1_MEAN_TOL):
            raise AssertionError(f"K1 disagrees with its plain version at H={H}: {e}, {e_mean}")
        err, ms, plain_ms = max(err, e), ms + t_k, plain_ms + t_p
    return err, ms, plain_ms


def _knn_case(dev, name, q, c, k, mask, values):
    idx, score, gathered = knn_batched(q, c, k, mask, gather_values=values)
    ref_idx, ref_score, _ = knn_plain(q, c, k + 1, mask, values)
    torch.cuda.synchronize()
    e = (score - ref_score[..., :k]).abs().max().item()
    # indices must agree wherever consecutive scores among the k+1 best are
    # separated by more than the tolerance (elsewhere the order is a tie)
    hi, lo = ref_score[..., :-1], ref_score[..., 1:]
    gaps = torch.where((hi < NEG / 2) & (lo < NEG / 2), torch.full_like(hi, float("inf")),
                       (hi - lo).abs())
    decided = gaps.min(-1).values > K2_TOL
    bad = (idx != ref_idx[..., :k]).any(-1) & decided
    bsel = torch.arange(q.shape[0], device=dev)[:, None, None]
    gather_exact = torch.equal(gathered, values[bsel, idx])
    t_k = median_ms(lambda: knn_batched(q, c, k, mask, gather_values=values))
    t_p = median_ms(lambda: knn_plain(q, c, k, mask, values))
    print(f"K2 knn {name} q={tuple(q.shape)} c={tuple(c.shape)} k={k} "
          f"Cv={values.shape[-1]}: max_abs_err {e:.3g} (tol {K2_TOL}), "
          f"{int(bad.sum())} index rows differ of {int(decided.sum())} decided, "
          f"gather exact {gather_exact}; kernel {t_k:.4f} ms plain {t_p:.4f} ms")
    if not (e <= K2_TOL and int(bad.sum()) == 0 and gather_exact):
        raise AssertionError(f"K2 disagrees with its plain version ({name})")
    return e, t_k, t_p


def check_k2(dev):
    """vismask 1-NN (Cv=64), voting against points (k=5, Cv=3), completion
    with query = cand and masked candidates (k=5, Cv=3)."""
    g = torch.Generator(device=dev).manual_seed(2)
    Bt = B_MESH * T
    vtx_f = l2_normalize(torch.randn(Bt, V_PAD, 64, device=dev, generator=g))
    pts_f = l2_normalize(torch.randn(Bt, P, 64, device=dev, generator=g))
    pts = torch.randn(Bt, P, 3, device=dev, generator=g)
    flow = torch.randn(Bt, V_PAD, 3, device=dev, generator=g)
    all_pts = torch.ones(Bt, P, dtype=torch.bool, device=dev)
    visible = torch.rand(Bt, V_PAD, device=dev, generator=g) < 0.4
    visible[0] = False                       # an all-masked batch row
    visible[1, 3:] = False                   # fewer than k valid candidates
    cases = [("vismask", vtx_f, pts_f, 1, all_pts, pts_f),
             ("voting", vtx_f, pts_f, 5, all_pts, pts),
             ("completion", vtx_f, vtx_f, 5, visible, flow)]
    res = [_knn_case(dev, *c) for c in cases]
    return max(r[0] for r in res), sum(r[1] for r in res), sum(r[2] for r in res)


def check_k3(dev):
    """Every (values, idx) shape of the main path, as (B, N, C, M); must be
    exact.  PointEncoder over the B*T clouds: sa1-3 grouping, fp3-1
    interpolation.  RootNet over 48 joint slots: sa1-2, fp2-1.  BoneNet's
    joint-set encoder: sa1-2."""
    g = torch.Generator(device=dev).manual_seed(3)
    Bt, J = B_MESH * T, 48
    shapes = [(Bt, 1024, 3, 512 * 64), (Bt, 512, 67, 128 * 64), (Bt, 128, 131, 32 * 64),
              (Bt, 32, 256, 128 * 3), (Bt, 128, 128, 512 * 3), (Bt, 512, 64, 1024 * 3),
              (B_MESH, J, 4, J * J), (B_MESH, J, 131, J // 3 * J),
              (B_MESH, J // 3, 256, J * 3), (B_MESH, J, 128, J * 3),
              (B_MESH, J, 3, J * J)]
    ms = plain_ms = 0.0
    for Bn, N, C, M in shapes:
        values = torch.randn(Bn, N, C, device=dev, generator=g)
        idx = torch.randint(0, N, (Bn, M), device=dev, generator=g)
        got, ref = gather_rows(values, idx), gather_plain(values, idx)
        exact = torch.equal(got, ref)
        t_k = median_ms(lambda: gather_rows(values, idx))
        t_p = median_ms(lambda: gather_plain(values, idx))
        print(f"K3 gather values=({Bn},{N},{C}) idx=({Bn},{M}): exact {exact}; "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} ms")
        if not exact:
            raise AssertionError(f"K3 is not exact at {(Bn, N, C, M)}")
        ms, plain_ms = ms + t_k, plain_ms + t_p
    return 0.0, ms, plain_ms


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------

def expected_edge_launches(pred: RigPredictor) -> int:
    """One K1 launch per EdgeMLP call: the motion trunks run once per keyframe."""
    return sum(T if "motionNet" in name else 1
               for net in (pred.deform, pred.joint, pred.mask, pred.root, pred.bone, pred.skin)
               for name, m in net.named_modules() if isinstance(m, EdgeMLP))


# K2: vismask + voting + completion in the one (B*T) DeformNet forward.
# K3: PointEncoder sa1-3 + fp3-1 (6), RootNet sa1-2 + fp2-1 (4), BoneNet's
# joint-set sa1-2 (2); the global FP stages broadcast and gather nothing.
EXPECTED_KNN_LAUNCHES = 3
EXPECTED_GATHER_LAUNCHES = 12


def check_rigs(rigs, entries):
    assert len(rigs) == B_MESH, len(rigs)
    for i, rig in enumerate(rigs):
        assert len(rig.pos) >= 1 and np.isfinite(rig.pos).all(), f"rig {i}: bad joints"
        n_valid = int(np.asarray(entries[i]["vert_mask"]).sum())
        assert rig.skins.shape == (n_valid, len(rig.pos)), (i, rig.skins.shape)
        if (rig.parents >= 0).any():                       # at least one bone
            err = np.abs(rig.skins.sum(1) - 1.0).max()
            assert err <= 1e-3, f"rig {i}: skin rows off 1 by {err}"


def time_main_path(pred: RigPredictor, entries, frames):
    """MAIN_REPS timed calls of predict_rig_batch, each checked.  The kernel
    counts are zeroed just before the first call and read just after it."""
    counters = (fused_edge_mlp, knn_batched, gather_rows)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, phases, launches = [], {}, None
    for _ in range(MAIN_REPS):
        timings: dict = {}
        t0 = time.perf_counter()
        rigs = pred.predict_rig_batch(entries, frames, timings=timings)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if launches is None:
            launches = [c.launches for c in counters]
        check_rigs(rigs, entries)
        for k, v in timings.items():
            phases.setdefault(k, []).append(v * 1e3)
    ms = np.asarray(walls) * 1e3
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"main path: {B_MESH} rigs, joints {[len(r.pos) for r in rigs]}; one call "
          f"median {med:.2f} ms (q1 {q1:.2f}, q3 {q3:.2f}, min {ms.min():.2f}, "
          f"max {ms.max():.2f}; {MAIN_REPS} calls): {B_MESH / med * 1e3:.3f} meshes/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("main path phase medians ms: "
          + ", ".join(f"{k} {np.median(v):.2f}" for k, v in phases.items()))
    return launches


# ---------------------------------------------------------------------------
# phase 5 (--profile only): where the time of one call goes
# ---------------------------------------------------------------------------

PROGRAMS = ("flow_joints", "skelnets", "skin_full")
KERNEL_NAMES = {"K1": "edge_mlp_kernel", "K2": "knn_kernel", "K3": "gather_rows_kernel"}


def profile_programs(pred: RigPredictor, entries, frames):
    """Each device program on the inputs the DAG gave it in one call: its
    CUDA-event median (device wall, launch gaps included) and, under
    torch.profiler, the kernels it launched, the device time they were busy,
    and the share of the three ported kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    captured = {}
    for name in PROGRAMS:
        def record(*args, _fn=getattr(pred, name), _name=name):
            captured[_name] = args
            return _fn(*args)
        setattr(pred, name, record)
    try:
        pred.predict_rig_batch(entries, frames)
    finally:
        for name in PROGRAMS:
            delattr(pred, name)
    for name in PROGRAMS:
        fn, args = getattr(pred, name), captured[name]
        wall = median_ms(lambda: fn(*args))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        by_name: dict = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        ported = []
        for k, sub in KERNEL_NAMES.items():
            n = sum(sub in e.name for e in dev)
            t = sum(v for op, v in by_name.items() if sub in op)
            ported.append(f"{k} {n} launches {t:.2f} ms")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        idle = f"{1 - busy / wall:.3f}" if dev else "not measured (no device events)"
        print(f"profile {name}: CUDA-event median {wall:.2f} ms; {len(dev)} device ops, "
              f"busy {busy:.2f} ms, idle share {idle}; " + "; ".join(ported))
        print(f"profile {name} top device ops ms: "
              + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top))


def profile_geometry(dev, entries, jc):
    """CUDA-event medians of FPS at the PointEncoder's three stages and of the
    clustering at the main path's shapes."""
    from morig_tpu_torch.geometry.clustering import select_and_cluster
    from morig_tpu_torch.kernels.neighbors import fps

    g = torch.Generator(device=dev).manual_seed(5)
    pts = torch.rand(B_MESH * T, P, 3, device=dev, generator=g)
    ones = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    for n_in, n_out in ((1024, 512), (512, 128), (128, 32)):
        t = median_ms(lambda: fps(pts[:, :n_in], n_out, ones[:, :n_in]))
        print(f"profile fps B={B_MESH * T} {n_in}->{n_out}: {t:.2f} ms")
    mesh = stack_meshes(entries, dev)
    shifted = mesh.verts + 0.05 * torch.randn(mesh.verts.shape, device=dev, generator=g)
    attn = torch.rand(mesh.vert_mask.shape, device=dev, generator=g)
    t = median_ms(lambda: select_and_cluster(
        shifted, attn, mesh.vert_mask, jc.bandwidth_quantile, jc.meanshift_max_iter,
        jc.attn_threshold, jc.bandwidth_sample_rows))
    print(f"profile select_and_cluster B={B_MESH} 2V={2 * V_PAD}: {t:.2f} ms")


def main(profile_phase: bool = False):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = gpu_name_power()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"({card}); torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = kb.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    kb.library()

    entries, frames = capsule_batch(B_MESH, T, P, V_PAD, DEGREE)
    mesh_bt = stack_meshes([e for e in entries for _ in range(T)], dev)
    results = {}
    for name, fn in (("K1", lambda: check_k1(dev, mesh_bt)), ("K2", lambda: check_k2(dev)),
                     ("K3", lambda: check_k3(dev))):
        results[name] = fn()

    pred = RigPredictor.random(0).to(dev)
    t0 = time.perf_counter()
    rigs = pred.predict_rig_batch(entries, frames)         # warm-up
    torch.cuda.synchronize()
    print(f"main path warm-up: {time.perf_counter() - t0:.3f} s")
    check_rigs(rigs, entries)

    launches = time_main_path(pred, entries, frames)
    expected = [expected_edge_launches(pred), EXPECTED_KNN_LAUNCHES, EXPECTED_GATHER_LAUNCHES]
    print(f"kernel launches in the first timed call (K1, K2, K3): {launches}, "
          f"expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != expected {expected}")
    if profile_phase:
        profile_programs(pred, entries, frames)
        profile_geometry(dev, entries, pred.cfg.joints)

    meta = {"K1": ("cuda", "morig_tpu_torch/csrc/edge_mlp.cu",
                   "morig_tpu/kernels/edge_fused.py:102"),
            "K2": ("cuda", "morig_tpu_torch/csrc/knn_topk.cu",
                   "morig_tpu/kernels/knn_fused.py:109"),
            "K3": ("cuda", "morig_tpu_torch/csrc/gather_rows.cu",
                   "morig_tpu/kernels/gather_fused.py:88")}
    kernels = []
    for (name, (route, src, rep)), n in zip(meta.items(), launches):
        err, ms, plain_ms = results[name]
        kernels.append({"name": name, "route": route, "source": src, "replaces": rep,
                        "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the three device programs, FPS and the clustering")
    main(parser.parse_args().profile)
