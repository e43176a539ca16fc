"""Joint-extraction clustering — counterpart of morig_tpu/geometry/clustering.py.

Device end (batched torch): bandwidth by geometric bisection (the JAX
default "auto" estimate), weighted flat-kernel mean-shift with a per-sample
convergence freeze, density counts, and `select_and_cluster` with or
without voxel containment.  Host end (numpy, copied as it is because the JAX module imports jax):
`nms_modes`, `symmetrize_reflect`, `flip_joints`, `nms_flip_host`.
`extract_joints` is the single-mesh procedure: host filtering and
reflection, then the device bandwidth and mean-shift on the one unpadded
cloud, then host NMS and flip; `extract_joints_batch` is its padded-batch
form, one device pass over the batch.
"""
from __future__ import annotations

import numpy as np
import torch

from morig_tpu_torch.geometry.voxel import inside_check
from morig_tpu_torch.kernels.neighbors import pairwise_sqdist


def estimate_bandwidth(pts: torch.Tensor, mask: torch.Tensor, quantile: float = 0.04,
                       sample_rows: int = 0) -> torch.Tensor:
    """(B,N,3), (B,N) -> (B,): mean over (strided sample) valid rows of the
    distance to the ceil-free int(n_valid*quantile)-th nearest valid point,
    found by 16 geometric bisection passes on the squared distance."""
    n = pts.shape[1]
    n_valid = mask.sum(1)
    knn = torch.clamp((n_valid.float() * quantile).to(torch.int64), min=1)
    if sample_rows and sample_rows < n:
        stride = max(n // sample_rows, 1)
        rows, rmask = pts[:, ::stride], mask[:, ::stride]
    else:
        rows, rmask = pts, mask
    valid = mask[:, None, :]
    d2 = torch.where(valid, pairwise_sqdist(rows, pts), torch.full((), 1e30, device=pts.device))
    hi = torch.clamp(torch.where(valid, d2, torch.zeros_like(d2)).max(-1).values, min=1e-12)
    lo = hi * 1e-9
    for _ in range(16):
        mid = torch.sqrt(lo * hi)
        ge = (d2 <= mid[..., None]).sum(-1) >= knn[:, None]
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    kth = torch.sqrt(torch.sqrt(lo * hi))
    m = rmask.float()
    return (kth * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def meanshift_cluster(pts, bandwidth, weights, mask, num_iter: int = 30,
                      step: float = 0.3) -> torch.Tensor:
    """Weighted flat-kernel mean-shift over (B,N,3).  Each sample runs passes
    while its displacement norm exceeds 1e-3, at most num_iter - 1 of them
    (the JAX while_loop counts from 1); a converged sample stays frozen."""
    B = pts.shape[0]
    w = torch.where(mask, weights, torch.zeros_like(weights))
    bw2 = (bandwidth * bandwidth)[:, None, None]
    it = torch.ones(B, dtype=torch.int64, device=pts.device)
    diff = torch.full((B,), 1e10, device=pts.device)
    x = pts
    for _ in range(num_iter - 1):
        active = (diff > 1e-3) & (it < num_iter)
        K = torch.clamp(bw2 - pairwise_sqdist(x, x), min=0.0) * w[:, :, None]
        col = K.sum(1, keepdim=True)
        P = (K / (col + 1e-10)).transpose(1, 2)
        x_new = x + step * (torch.matmul(P, x) - x)
        d = torch.sqrt(((x_new - x) ** 2).sum((1, 2)))
        x = torch.where(active[:, None, None], x_new, x)
        diff = torch.where(active, d, diff)
        it = it + active.to(torch.int64)
    return x


def select_and_cluster(shifted, attn, vert_mask, quantile: float = 0.04, num_iter: int = 30,
                       attn_threshold: float = 0.1, sample_rows: int = 0, vox=None):
    """Device end of joint extraction, mirror-symmetrized: attention
    min-max over valid vertices, selection (with `vox`, the voxel triple of
    geometry/voxel.py, only shifted points inside their mesh's grid),
    reflection, bandwidth, mean-shift and density counts.  Returns (moved
    (B,2V,3), bw (B,), counts (B,2V), attn2 (B,2V), sel2 (B,2V))."""
    inf = torch.full((), float("inf"), device=attn.device)
    hi = torch.where(vert_mask, attn, -inf).max(1, keepdim=True).values
    lo = torch.where(vert_mask, attn, inf).min(1, keepdim=True).values
    spread = hi - lo
    a_n = torch.where(spread > 1e-10,
                      (attn - lo) / torch.where(spread > 1e-10, spread, torch.ones_like(spread)),
                      attn)
    sel = vert_mask & (a_n > attn_threshold)
    if vox is not None:
        sel = sel & inside_check(shifted, *vox)
    mirror = torch.tensor([-1.0, 1.0, 1.0], device=shifted.device)
    pts2 = torch.cat([shifted, shifted * mirror], 1)
    a2 = torch.cat([a_n, a_n], 1)
    sel2 = torch.cat([sel, sel], 1)
    bw = estimate_bandwidth(pts2, sel2, quantile, sample_rows)
    moved = meanshift_cluster(pts2, bw, a2.float(), sel2, num_iter)
    within = (pairwise_sqdist(moved, moved) <= (bw * bw)[:, None, None]) & sel2[:, None, :]
    counts = within.sum(2) * sel2
    return moved, bw, counts, a2, sel2


# ---------------------------------------------------------------------------
# host tail (numpy)
# ---------------------------------------------------------------------------

def nms_modes(pts, attn, bandwidth, density_threshold=0.02, attn_threshold=0.7,
              mask=None, counts=None, return_density=False):
    """Greedy density-sorted mode extraction after mean-shift: visit points
    by descending neighbor count, suppress everything within the bandwidth,
    keep the visited point if its neighborhood's max attention or density
    clears the thresholds."""
    pts = np.asarray(pts)
    attn = np.asarray(attn).reshape(-1)
    if mask is not None:
        pts = pts[mask]
        attn = attn[np.asarray(mask)]
        if counts is not None:
            counts = np.asarray(counts)[np.asarray(mask)]
    n = len(pts)
    if n == 0:
        empty = np.zeros((0, 3), np.float32)
        return (empty, np.zeros(0)) if return_density else empty
    if counts is None:
        d2 = ((pts[None] - pts[:, None]) ** 2).sum(-1)
        counts = (d2 <= bandwidth * bandwidth).sum(0)
    order = np.argsort(np.asarray(counts))[::-1]
    bw2 = bandwidth * bandwidth
    alive = np.ones(n, bool)
    keep = np.zeros(n, bool)
    for i in order:
        if not alive[i]:
            continue
        nbrs = ((pts - pts[i]) ** 2).sum(-1) <= bw2
        alive[nbrs] = False
        if attn[nbrs].max() > attn_threshold or nbrs.sum() / n > density_threshold:
            keep[i] = True
    if return_density:
        return pts[keep], np.asarray(counts)[keep]
    return pts[keep]


def symmetrize_reflect(pts: np.ndarray, attn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Double the point set with its x-mirror before clustering."""
    mirrored = pts * np.array([[-1.0, 1.0, 1.0]], dtype=pts.dtype)
    return np.concatenate([pts, mirrored], 0), np.concatenate([attn, attn], 0)


def flip_joints(joints, tol=2e-2, extra=None):
    """Mirror left-half joints to the right, snap middle joints to the plane.
    Returns (joints, side) with side in {-1,0,1}; with `extra` (per-joint
    payload) also returns it rearranged alongside."""
    joints = np.asarray(joints, dtype=np.float32)
    is_left = joints[:, 0] < -tol
    is_mid = np.abs(joints[:, 0]) <= tol
    left = joints[is_left]
    middle = joints[is_mid].copy()
    middle[:, 0] = 0.0
    right = left.copy()
    right[:, 0] = -right[:, 0]
    out = np.concatenate([left, middle, right], axis=0)
    side = np.concatenate([-np.ones(len(left)), np.zeros(len(middle)), np.ones(len(right))])
    if extra is not None:
        extra = np.asarray(extra)
        extra_out = np.concatenate([extra[is_left], extra[is_mid], extra[is_left]])
        return out, side, extra_out
    return out, side


def nms_flip_host(moved, bws, counts, attn2, sel2, density_threshold=0.02,
                  attn_nms_threshold=0.7, symmetrize=True, return_density=False):
    """Per-mesh NMS + flip over the fetched `select_and_cluster` outputs;
    with return_density each entry is (modes, densities)."""
    out = []
    for i in range(len(moved)):
        m = np.asarray(sel2[i])
        if not m.any():
            empty = np.zeros((0, 3), np.float32)
            out.append((empty, np.zeros(0)) if return_density else empty)
            continue
        modes, dens = nms_modes(np.asarray(moved[i])[m], np.asarray(attn2[i])[m],
                                float(bws[i]), density_threshold, attn_nms_threshold,
                                counts=np.asarray(counts[i])[m], return_density=True)
        if symmetrize:
            modes, _, dens = flip_joints(modes, extra=dens)
        out.append((modes, dens) if return_density else modes)
    return out


def extract_joints(shifted_pts: np.ndarray, attn: np.ndarray, inside_fn=None,
                   bandwidth_quantile: float = 0.04, attn_keep_threshold: float = 0.1,
                   density_threshold: float = 0.02, attn_nms_threshold: float = 0.7,
                   meanshift_iters: int = 30, symmetrize: bool = True,
                   bandwidth_sample_rows: int = 0, device="cuda") -> np.ndarray:
    """Shifted points (N, 3) and their attention (N,) -> joints (J, 3): the
    attention min-max normalized (kept as it is when constant), points
    outside `inside_fn` and below `attn_keep_threshold` dropped, reflected,
    then bandwidth and mean-shift on `device` over the remaining cloud, host
    NMS and flip."""
    attn = np.asarray(attn).reshape(-1).astype(np.float64)
    spread = attn.max() - attn.min()
    if spread > 1e-10:
        attn = (attn - attn.min()) / spread
    pts = np.asarray(shifted_pts, np.float32)
    if inside_fn is not None:
        ok = inside_fn(pts)
        pts, attn = pts[ok], attn[ok]
    sel = attn > attn_keep_threshold
    pts, attn = pts[sel], attn[sel]
    if len(pts) == 0:
        return np.zeros((0, 3), np.float32)
    if symmetrize:
        pts, attn = symmetrize_reflect(pts, attn)
    p = torch.as_tensor(pts, device=device)[None]
    mask = torch.ones(p.shape[:2], dtype=torch.bool, device=device)
    bw = estimate_bandwidth(p, mask, bandwidth_quantile, bandwidth_sample_rows)
    w = torch.as_tensor(attn, dtype=torch.float32, device=device)[None]
    moved = meanshift_cluster(p, bw, w, mask, meanshift_iters)[0].cpu().numpy()
    modes = nms_modes(moved, attn, float(bw[0]), density_threshold, attn_nms_threshold)
    if symmetrize:
        modes, _ = flip_joints(modes)
    return modes


def extract_joints_batch(shifted: np.ndarray, attn: np.ndarray, valid_mask: np.ndarray,
                         inside_fns=None, bandwidth_quantile: float = 0.04,
                         attn_keep_threshold: float = 0.1, density_threshold: float = 0.02,
                         attn_nms_threshold: float = 0.7, meanshift_iters: int = 30,
                         symmetrize: bool = True, bandwidth_sample_rows: int = 0,
                         device="cuda") -> list:
    """The padded-batch form of `extract_joints`: shifted (B,V,3), attn
    (B,V) and valid_mask (B,V) -> per mesh its joints (J, 3).  Host
    filtering (attention min-max over the valid points, `inside_fns[i]`
    where given, `attn_keep_threshold`) and reflection as masks, then one
    batched bandwidth, mean-shift and density count on `device` over the
    whole padded batch (masked points neither attract nor count), then host
    NMS and flip per mesh."""
    Bn = attn.shape[0]
    shifted = np.asarray(shifted, np.float32)
    attn = np.asarray(attn, np.float64)
    sel = np.asarray(valid_mask, bool).copy()
    attn_n = np.zeros_like(attn)
    for i in range(Bn):
        a, v = attn[i], sel[i]
        if v.any():
            lo, hi = a[v].min(), a[v].max()
            attn_n[i] = (a - lo) / (hi - lo) if hi - lo > 1e-10 else a
        if inside_fns is not None and inside_fns[i] is not None:
            sel[i] &= np.asarray(inside_fns[i](shifted[i]), bool)
        sel[i] &= attn_n[i] > attn_keep_threshold
    if symmetrize:
        pts2 = np.concatenate([shifted, shifted * np.array([[[-1.0, 1.0, 1.0]]], np.float32)], 1)
        attn2, sel2 = np.concatenate([attn_n, attn_n], 1), np.concatenate([sel, sel], 1)
    else:
        pts2, attn2, sel2 = shifted, attn_n, sel
    p = torch.as_tensor(pts2, device=device)
    m = torch.as_tensor(sel2, device=device)
    bw = estimate_bandwidth(p, m, bandwidth_quantile, bandwidth_sample_rows)
    moved = meanshift_cluster(p, bw, torch.as_tensor(attn2, dtype=torch.float32, device=device),
                              m, meanshift_iters)
    within = (pairwise_sqdist(moved, moved) <= (bw * bw)[:, None, None]) & m[:, None, :]
    counts = within.sum(2) * m
    return nms_flip_host(moved.cpu().numpy(), bw.cpu().numpy(), counts.cpu().numpy(), attn2,
                         sel2, density_threshold, attn_nms_threshold, symmetrize)
