"""Dense neighbor search — counterpart of morig_tpu/kernels/neighbors.py.

Batched forms of the JAX per-sample functions (the JAX package vmaps them):
every function takes a leading batch axis.  Selection is exact: top-k is k
first-index-wins argmax sweeps, and radius grouping keeps the exact nearest
neighbors (the TPU's approx_max_k has no counterpart here).
"""
from __future__ import annotations

import torch

from morig_tpu_torch.kernels.gather_fused import gather_plain, gather_rows

NEG = -1e30
POS = 1e30


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B,N,3) x (B,M,3) -> (B,N,M) squared distances via the matmul expansion."""
    xx = (x * x).sum(-1, keepdim=True)
    yy = (y * y).sum(-1, keepdim=True)
    return torch.clamp(xx + yy.transpose(1, 2) - 2.0 * torch.matmul(x, y.transpose(1, 2)),
                       min=0.0)


def topk_small(sim: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis by k argmax sweeps, first index winning ties.
    Returns (scores (..., k), idx (..., k) int64)."""
    scores, idxs = [], []
    s = sim
    for _ in range(k):
        smax, i = s.max(dim=-1)
        scores.append(smax)
        idxs.append(i)
        s = s.scatter(-1, i[..., None], NEG)
    return torch.stack(scores, -1), torch.stack(idxs, -1)


def knn(query, cand, k: int, cand_mask=None):
    """Euclidean top-k: (B,N,3), (B,M,3) -> idx (B,N,k), score = -d^2 (B,N,k).
    With fewer than k candidates the last column repeats with score NEG."""
    sim = -pairwise_sqdist(query, cand)
    if cand_mask is not None:
        sim = torch.where(cand_mask[:, None, :], sim, torch.full_like(sim, NEG))
    k_eff = min(k, cand.shape[1])
    score, idx = topk_small(sim, k_eff)
    if k_eff < k:
        pad = k - k_eff
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:-1], pad)], -1)
        score = torch.cat([score, torch.full(score.shape[:-1] + (pad,), NEG,
                                             dtype=score.dtype, device=score.device)], -1)
    return idx, score


def knn_interpolate(x, pos_src, pos_tar, k: int = 3, src_mask=None, eps: float = 1e-8,
                    train: bool = False):
    """Inverse-distance-weighted kNN interpolation: (B,M,C) features at
    (B,M,3) source positions -> (B,N,C) at (B,N,3) targets, each the mean of
    its k nearest valid sources weighted by 1 / (d^2 + eps).  The rows are
    gathered by K3 (`gather_rows`, fp32 x), in training by differentiable
    indexing."""
    idx, negd2 = knn(pos_tar, pos_src, k, cand_mask=src_mask)
    w = 1.0 / (torch.clamp(-negd2, min=0.0) + eps)
    w = w / w.sum(-1, keepdim=True)
    return ((gather_plain if train else gather_rows)(x, idx) * w[..., None]).sum(2)


def radius_group(centroids, points, r: float, max_neighbors: int, points_mask=None):
    """Up to max_neighbors points within radius r of each centroid, nearest
    first: (B,K,3), (B,P,3) -> idx (B,K,M) int64, valid (B,K,M) bool."""
    d2 = pairwise_sqdist(centroids, points)
    in_r = d2 <= r * r
    if points_mask is not None:
        in_r = in_r & points_mask[:, None, :]
    score = torch.where(in_r, -d2, torch.full_like(d2, NEG))
    k = min(max_neighbors, points.shape[1])
    # stable descending sort = lax.top_k order (equal scores keep index order)
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return idx[..., :k], top[..., :k] > NEG / 2


def fps(points: torch.Tensor, k: int, mask: torch.Tensor | None = None,
        start: torch.Tensor | None = None) -> torch.Tensor:
    """Farthest-point sampling of k indices per sample from (B,P,3), starting
    at `start` (B,) (index 0 when None, the eval start); masked points are
    never picked after the start.  A sequential loop over k on the device."""
    B, P, _ = points.shape
    valid = torch.ones(B, P, dtype=torch.bool, device=points.device) if mask is None else mask
    bsel = torch.arange(B, device=points.device)
    dist = torch.where(valid, torch.full((B, P), POS, device=points.device),
                       torch.full((B, P), -1.0, device=points.device))
    last = (torch.zeros(B, dtype=torch.int64, device=points.device) if start is None
            else start.to(device=points.device, dtype=torch.int64))
    out = [last]
    for _ in range(k - 1):
        d_new = ((points - points[bsel, last][:, None, :]) ** 2).sum(-1)
        dist = torch.minimum(dist, d_new)
        last = torch.where(valid, dist, torch.full_like(dist, -1.0)).argmax(dim=-1)
        out.append(last)
    return torch.stack(out, 1)


def random_starts(generator: torch.Generator | None, mask: torch.Tensor) -> torch.Tensor:
    """A uniformly drawn valid FPS start per sample of mask (B,P), from
    `generator` (random in training, as morig_tpu/nn/corrnet.py
    `random_starts`); 0 when generator is None (the eval start).  The draws
    come from the generator's own device and land on mask's."""
    B = mask.shape[0]
    if generator is None:
        return torch.zeros(B, dtype=torch.int64, device=mask.device)
    u = torch.rand(mask.shape, generator=generator, device=generator.device)
    u = torch.where(mask.to(u.device), u, torch.full_like(u, -1.0))
    return u.argmax(dim=-1).to(mask.device)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int, eps: float = 1e-10) -> torch.Tensor:
    """Mean over `dim` of the unmasked entries (mask a prefix of x's axes);
    0 where all are masked."""
    while mask.dim() < x.dim():
        mask = mask[..., None]
    num = torch.where(mask, x, torch.zeros_like(x)).sum(dim)
    den = mask.to(x.dtype).sum(dim)
    return num / torch.clamp(den, min=eps)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Max over `dim` treating masked entries as -inf; 0 where all are masked."""
    while mask.dim() < x.dim():
        mask = mask[..., None]
    filled = torch.where(mask, x, torch.full_like(x, NEG))
    out = filled.max(dim=dim).values
    return torch.where(mask.any(dim=dim), out, torch.zeros_like(out))
