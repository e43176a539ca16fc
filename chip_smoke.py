"""Smoke run of the PyTorch/CUDA port (morig_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # what the smoke check runs
    python3 chip_smoke.py --profile   # plus phase 5

Phases, each printing its own lines:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — compiles the kernels from csrc/ with nvcc (sm_90a), one
               process per source, all started together;
  3. kernels — each of K1 (edge MLP), K2 (kNN + gather), K3 (row gather),
               K4 (kNN) and K5 (windowed edge MLP) against its plain PyTorch
               version on the card, at the shapes the paths give it (K5
               also against K1), with errors, tolerances and CUDA-event
               median times;
  4. paths   — `RigPredictor.predict_rig_batch` on B=4 capsule meshes
               (V=1298 padded to 1536, degree-12 tables, P=1024, T=5) with
               seeded random weights (heads included), in two
               configurations.  Path 1: no voxels, euclidean skin
               distances, every edge layer on K1.  Path 2 (bench.py phase
               A's serving configuration): an 88^3 voxel grid and the
               surface-geodesic matrix per mesh, a device cache, the edge
               dispatch `auto_select_edge_impl(entries, tile_v=128)`
               chooses, which must be the windowed K5, and JointNet's head
               scaled so shifted points land in the volume
               (`phase_a_predictor`).  Each: one warm-up
               call, then 7 timed calls, each checked; the kernel counts
               are zeroed just before the first timed call and read just
               after it, and must equal the expected launches; prints the
               call's median and quartiles, meshes/s, per-phase medians and
               peak device memory;
  5. profile (--profile only) — for each path, each device program's
               CUDA-event time, its device ops and busy time under
               torch.profiler and the ported kernels' share; CUDA-event
               times of FPS and the clustering.
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
from morig_tpu_torch.data.synthetic import capsule_batch, make_capsule_rig
from morig_tpu_torch.geometry.geodesic import surface_geodesic
from morig_tpu_torch.geometry.voxel import voxelize_mesh
from morig_tpu_torch.kernels import build as kb
from morig_tpu_torch.kernels.edge_fused import (
    edge_mlp_plain, edge_mlp_windowed_plain, fused_edge_mlp, fused_edge_mlp_windowed)
from morig_tpu_torch.kernels.gather_fused import gather_plain, gather_rows
from morig_tpu_torch.kernels.knn_fused import NEG, knn_batched, knn_plain, knn_topk
from morig_tpu_torch.nn.corrnet import l2_normalize
from morig_tpu_torch.nn.gcu import EdgeMLP, auto_select_edge_impl
from morig_tpu_torch.pipelines.rig_predict import RigPredictor

B_MESH, T, P, V_PAD, DEGREE = 4, 5, 1024, 1536, 12
EDGE_TILE, VOX_DIMS = 128, 88
# K1: the kernel and the plain version round LN1 outputs (|h| up to ~6) to
# bf16 from fp32 values that differ in the last bits, so a rare element
# lands one bf16 ulp (2^-8 relative) apart; through W2 and LN2 that moves
# an O(1) output by up to ~2e-2.  The mean error stays at fp32 level
# (below 7e-7 at every width on the H100), so it is held to 1e-5.
K1_TOL, K1_MEAN_TOL = 3e-2, 1e-5
# K5 is K1's arithmetic with the rows read from the window: the same bounds,
# against its plain version and against K1 (the tables are local).
K2_TOL = 1e-5     # fp32 sums of exact bf16 products, in another order; K4 too
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

EDGE_WIDTHS = (16, 32, 64, 128, 256)


def edge_args(dev, mesh_bt, H, g):
    Bt, V, _ = mesh_bt.tpl_nbr.shape
    a = torch.randn(Bt, V, H, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(Bt, V, H, device=dev, generator=g).to(torch.bfloat16)
    w2 = torch.randn(H, H, device=dev, generator=g) / math.sqrt(H)
    vecs = [0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g)]
    return (a, b, mesh_bt.tpl_nbr, mesh_bt.tpl_mask, w2, *vecs)


def check_k1(dev, mesh_bt):
    """Every edge width of the paths, over the B*T tables of the flow program."""
    g = torch.Generator(device=dev).manual_seed(1)
    Bt, V, D = mesh_bt.tpl_nbr.shape
    err = ms = plain_ms = 0.0
    for H in EDGE_WIDTHS:
        args = edge_args(dev, mesh_bt, H, g)
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


def check_k5(dev, mesh_bt):
    """Every edge width of the paths over the same B*T tables (local at the
    dispatch tile): K5 against its plain version and against K1."""
    g = torch.Generator(device=dev).manual_seed(1)
    Bt, V, D = mesh_bt.tpl_nbr.shape
    err = ms = plain_ms = 0.0
    for H in EDGE_WIDTHS:
        args = edge_args(dev, mesh_bt, H, g)
        got = fused_edge_mlp_windowed(*args, tile_v=EDGE_TILE)
        ref = edge_mlp_windowed_plain(*args, tile_v=EDGE_TILE)
        k1 = fused_edge_mlp(*args)
        torch.cuda.synchronize()
        e, e_mean = (got - ref).abs().max().item(), (got - ref).abs().mean().item()
        e1, e1_mean = (got - k1).abs().max().item(), (got - k1).abs().mean().item()
        t_k = median_ms(lambda: fused_edge_mlp_windowed(*args, tile_v=EDGE_TILE))
        t_p = median_ms(lambda: edge_mlp_windowed_plain(*args, tile_v=EDGE_TILE))
        t_1 = median_ms(lambda: fused_edge_mlp(*args))
        print(f"K5 edge_mlp_windowed B={Bt} V={V} D={D} H={H} tile={EDGE_TILE}: max_abs_err "
              f"{e:.3g} (tol {K1_TOL}), mean {e_mean:.3g} (tol {K1_MEAN_TOL}); against K1 max "
              f"{e1:.3g}, mean {e1_mean:.3g}; kernel {t_k:.4f} ms plain {t_p:.4f} ms "
              f"K1 {t_1:.4f} ms")
        if not (e <= K1_TOL and e_mean <= K1_MEAN_TOL and e1 <= K1_TOL
                and e1_mean <= K1_MEAN_TOL):
            raise AssertionError(f"K5 disagrees with its plain version or K1 at H={H}")
        err, ms, plain_ms = max(err, e), ms + t_k, plain_ms + t_p
    return err, ms, plain_ms


def _knn_case(dev, name, q, c, k, mask, values):
    """K2 (values given) or K4 (values None) against knn_plain: scores within
    K2_TOL, indices equal wherever the order is decided, gather exact."""
    out = knn_batched(q, c, k, mask, gather_values=values)
    idx, score = out[:2]
    ref_idx, ref_score = knn_plain(q, c, k + 1, mask)
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
    gather_exact = values is None or torch.equal(out[2], values[bsel, idx])
    t_k = median_ms(lambda: knn_batched(q, c, k, mask, gather_values=values))
    t_p = median_ms(lambda: knn_plain(q, c, k, mask, values))
    kernel = "K4" if values is None else "K2"
    cv = "" if values is None else f" Cv={values.shape[-1]}"
    print(f"{kernel} knn {name} q={tuple(q.shape)} c={tuple(c.shape)} k={k}{cv}: max_abs_err "
          f"{e:.3g} (tol {K2_TOL}), {int(bad.sum())} index rows differ of "
          f"{int(decided.sum())} decided, gather exact {gather_exact}; "
          f"kernel {t_k:.4f} ms plain {t_p:.4f} ms")
    if not (e <= K2_TOL and int(bad.sum()) == 0 and gather_exact):
        raise AssertionError(f"{kernel} disagrees with its plain version ({name})")
    return e, t_k, t_p


def knn_inputs(dev):
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
    return vtx_f, pts_f, pts, flow, all_pts, visible


def _sum_cases(res):
    return max(r[0] for r in res), sum(r[1] for r in res), sum(r[2] for r in res)


def check_k2(dev):
    """vismask 1-NN (Cv=64), voting against points (k=5, Cv=3), completion
    with query = cand and masked candidates (k=5, Cv=3)."""
    vtx_f, pts_f, pts, flow, all_pts, visible = knn_inputs(dev)
    cases = [("vismask", vtx_f, pts_f, 1, all_pts, pts_f),
             ("voting", vtx_f, pts_f, 5, all_pts, pts),
             ("completion", vtx_f, vtx_f, 5, visible, flow)]
    return _sum_cases([_knn_case(dev, *c) for c in cases])


def check_k4(dev):
    """K2's vismask (k=1) and voting (k=5) shapes without the gather."""
    vtx_f, pts_f, _, _, all_pts, _ = knn_inputs(dev)
    cases = [("vismask", vtx_f, pts_f, 1, all_pts, None),
             ("voting", vtx_f, pts_f, 5, all_pts, None)]
    return _sum_cases([_knn_case(dev, *c) for c in cases])


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
# phase 4: the two paths
# ---------------------------------------------------------------------------

def expected_edge_launches(pred: RigPredictor) -> int:
    """One edge-kernel launch per EdgeMLP call (K1 on path 1, K5 on path 2):
    the motion trunks run once per keyframe."""
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


COUNTERS = {"K1": fused_edge_mlp, "K2": knn_batched, "K3": gather_rows, "K4": knn_topk,
            "K5": fused_edge_mlp_windowed}


def time_path(name: str, pred: RigPredictor, entries, frames, **kw):
    """MAIN_REPS timed calls of predict_rig_batch, each checked.  The kernel
    counts are zeroed just before the first call and read just after it;
    returns them by kernel."""
    for c in COUNTERS.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, phases, launches = [], {}, None
    for _ in range(MAIN_REPS):
        timings: dict = {}
        t0 = time.perf_counter()
        rigs = pred.predict_rig_batch(entries, frames, timings=timings, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if launches is None:
            launches = {k: c.launches for k, c in COUNTERS.items()}
        check_rigs(rigs, entries)
        for k, v in timings.items():
            phases.setdefault(k, []).append(v * 1e3)
    ms = np.asarray(walls) * 1e3
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"{name}: {B_MESH} rigs, joints {[len(r.pos) for r in rigs]}; one call "
          f"median {med:.2f} ms (q1 {q1:.2f}, q3 {q3:.2f}, min {ms.min():.2f}, "
          f"max {ms.max():.2f}; {MAIN_REPS} calls): {B_MESH / med * 1e3:.3f} meshes/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{name} phase medians ms: "
          + ", ".join(f"{k} {np.median(v):.2f}" for k, v in phases.items()))
    return launches


def serve(name: str, pred: RigPredictor, entries, frames, expected: dict, **kw):
    """One warm-up call, then the timed calls; checks the launch counts of
    the first timed call against `expected`."""
    t0 = time.perf_counter()
    rigs = pred.predict_rig_batch(entries, frames, **kw)
    torch.cuda.synchronize()
    print(f"{name} warm-up: {time.perf_counter() - t0:.3f} s")
    check_rigs(rigs, entries)
    launches = time_path(name, pred, entries, frames, **kw)
    print(f"{name} kernel launches in the first timed call: {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"{name}: kernel launches {launches} != expected {expected}")
    return launches


# ---------------------------------------------------------------------------
# phase 5 (--profile only): where the time of one call goes
# ---------------------------------------------------------------------------

PROGRAMS = ("flow_joints", "skelnets", "skin_full")
KERNEL_NAMES = {"K1": "edge_mlp_kernel", "K2": "knn_kernel", "K3": "gather_rows_kernel",
                "K5": "edge_mlp_windowed_kernel"}


def profile_programs(path: str, pred: RigPredictor, entries, frames, **kw):
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
        pred.predict_rig_batch(entries, frames, **kw)
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
        print(f"profile {path} {name}: CUDA-event median {wall:.2f} ms; {len(dev)} device "
              f"ops, busy {busy:.2f} ms, idle share {idle}; " + "; ".join(ported))
        print(f"profile {path} {name} top device ops ms: "
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


SHIFT_SCALE = 0.1


def phase_a_predictor(seed: int = 0) -> RigPredictor:
    """`RigPredictor.random(seed)` with JointNet's output layer scaled by
    SHIFT_SCALE.  A random head moves vertices by tanh of O(1) values, up to
    a unit, far out of the capsule (radius 0.12): with voxel containment no
    shifted point is then inside, every mesh falls back to one joint and the
    skeleton and skin stages run on one bone.  Scaled, the shifts are of the
    capsule's size, as a trained JointNet's (which moves vertices toward
    the skeleton inside the mesh) are, and the meshes get over ten joints."""
    pred = RigPredictor.random(seed)
    with torch.no_grad():
        for p in pred.joint.jointnet.mlp_transform.out.parameters():
            p.mul_(SHIFT_SCALE)
    return pred


def phase_a_inputs(entries):
    """bench.py phase A's per-mesh preprocessing, once before timing: the
    capsule's 88^3 voxel grid and its surface-geodesic matrix."""
    cap = make_capsule_rig(37, 36)
    t0 = time.perf_counter()
    vox = voxelize_mesh(cap.verts, cap.faces, dims=VOX_DIMS)
    t1 = time.perf_counter()
    sg = surface_geodesic(cap.verts, cap.faces)
    t2 = time.perf_counter()
    impl = auto_select_edge_impl(entries, tile_v=EDGE_TILE)
    print(f"path 2 inputs: {VOX_DIMS}^3 grid ({int(vox.data.sum())} cells inside) in "
          f"{t1 - t0:.2f} s, surface geodesics {sg.shape} in {t2 - t1:.2f} s; edge dispatch "
          f"at tile {EDGE_TILE}: {impl}")
    if impl != "windowed":
        raise AssertionError(f"path 2 needs the windowed dispatch, got {impl}")
    return dict(voxes=[vox] * len(entries), surf_geos=[sg] * len(entries),
                edge_tile=EDGE_TILE)


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
    knn_topk.launches = 0
    results = {}
    for name, fn in (("K1", lambda: check_k1(dev, mesh_bt)), ("K2", lambda: check_k2(dev)),
                     ("K3", lambda: check_k3(dev)), ("K4", lambda: check_k4(dev)),
                     ("K5", lambda: check_k5(dev, mesh_bt))):
        results[name] = fn()
    k4_launches = knn_topk.launches

    pred = RigPredictor.random(0).to(dev)
    edge = expected_edge_launches(pred)
    path1 = serve("path 1", pred, entries, frames,
                  dict(K1=edge, K2=EXPECTED_KNN_LAUNCHES, K3=EXPECTED_GATHER_LAUNCHES, K4=0,
                       K5=0))
    phase_a = phase_a_inputs(entries)
    pred2 = phase_a_predictor(0).to(dev)
    cache: dict = {}
    path2 = serve("path 2", pred2, entries, frames,
                  dict(K1=0, K2=EXPECTED_KNN_LAUNCHES, K3=EXPECTED_GATHER_LAUNCHES, K4=0,
                       K5=edge), device_cache=cache, **phase_a)
    if profile_phase:
        profile_programs("path 1", pred, entries, frames)
        profile_programs("path 2", pred2, entries, frames, device_cache=cache, **phase_a)
        profile_geometry(dev, entries, pred.cfg.joints)

    meta = {"K1": ("cuda", "morig_tpu_torch/csrc/edge_mlp.cu",
                   "morig_tpu/kernels/edge_fused.py:102", path1["K1"]),
            "K2": ("cuda", "morig_tpu_torch/csrc/knn_topk.cu",
                   "morig_tpu/kernels/knn_fused.py:109", path1["K2"]),
            "K3": ("cuda", "morig_tpu_torch/csrc/gather_rows.cu",
                   "morig_tpu/kernels/gather_fused.py:88", path1["K3"]),
            "K4": ("cuda", "morig_tpu_torch/csrc/knn_topk.cu",
                   "morig_tpu/kernels/knn_fused.py:109", k4_launches),
            "K5": ("cuda", "morig_tpu_torch/csrc/edge_mlp.cu",
                   "morig_tpu/kernels/edge_fused.py:235", path2["K5"])}
    kernels = []
    for name, (route, src, rep, n) in meta.items():
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
                        help="also profile each path's three device programs, FPS and the "
                             "clustering")
    main(parser.parse_args().profile)
