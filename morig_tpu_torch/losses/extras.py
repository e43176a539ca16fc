"""Auxiliary losses of the reference's inventory, off the main training path
— counterpart of morig_tpu/losses/extras.py: log-ratio metric learning,
hinge embedding, multi-label BCE, transition, motion and grouping losses,
per-sample IoU after Hungarian matching, and skin-difference
regularization.

The JAX module samples rows with jax.random inside the losses; here the
draw is `draw_rows` (losses/nce.py: distinct valid rows per sample, from an
explicit generator), made apart from the loss: each sampled loss has a
`*_drawn` form that takes the (B, S) row indices, which a test can take
from JAX, and a form that draws them from a generator first.  On a mesh
(parallel/mesh.py) the batch means are this rank's share; `iou_loss` takes
one sample and stays local.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from morig_tpu_torch.losses.nce import _rows, draw_rows
from morig_tpu_torch.parallel import batch_mean, batch_sum


def _bce_logits(s: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.clamp(s, min=0.0) - s * gt + torch.log1p(torch.exp(-s.abs()))


def log_ratio_loss_drawn(feature: torch.Tensor, gt_skin: torch.Tensor, ids: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Log-distance-ratio metric learning on the rows `ids` (B, S): for each
    pair of row pairs, the difference of their log squared feature
    distances should equal that of their log squared skin distances; the
    squared mismatch averaged over the ordered pairs of pairs, then over
    the batch."""
    pairs = torch.as_tensor(list(itertools.combinations(range(ids.shape[1]), 2)),
                            device=feature.device)
    fs, ss = _rows(feature, ids), _rows(gt_skin, ids)
    d = ((fs[:, pairs[:, 0]] - fs[:, pairs[:, 1]]) ** 2).sum(-1)             # (B, n)
    gd = ((ss[:, pairs[:, 0]] - ss[:, pairs[:, 1]]) ** 2).sum(-1)
    ld, lgd = torch.log(d + eps), torch.log(gd + eps)
    diff = (ld[:, None, :] - ld[:, :, None]) - (lgd[:, None, :] - lgd[:, :, None])
    n = pairs.shape[0]
    w = torch.triu(torch.ones(n, n, device=feature.device), diagonal=1)
    w = w / torch.clamp(w.sum(), min=1.0)
    return batch_mean((diff * diff * w).sum((-2, -1)))


def log_ratio_loss(generator: Optional[torch.Generator], feature, gt_skin, vert_mask,
                   num_sample: int = 50, eps: float = 1e-6) -> torch.Tensor:
    return log_ratio_loss_drawn(feature, gt_skin, draw_rows(generator, vert_mask, num_sample), eps)


def hinge_embedding_loss_drawn(feature: torch.Tensor, gt_skin: torch.Tensor, ids: torch.Tensor,
                               margin: float = 0.2, pos_weight: float = 10.0,
                               sim_threshold: float = 0.9) -> torch.Tensor:
    """Weighted hinge embedding over the pairs of rows `ids`: pairs of
    similar skin (above sim_threshold) pull their feature distance
    (1 - cos) / 2 to 0 with weight pos_weight, the others push it past
    `margin`."""
    fs, ss = _rows(feature, ids), _rows(gt_skin, ids)
    dist = (1.0 - fs @ fs.transpose(1, 2)) / 2.0
    gt_sim = (2.0 - (ss[:, None] - ss[:, :, None]).abs().sum(-1)) / 2.0
    pos = gt_sim > sim_threshold
    w = torch.where(pos, torch.full_like(dist, pos_weight), torch.ones_like(dist))
    per = torch.where(pos, dist, torch.clamp(margin - dist, min=0.0))
    return batch_mean((per * w * w).sum((-2, -1)) / torch.clamp(w.sum((-2, -1)), min=1.0))


def hinge_embedding_loss(generator: Optional[torch.Generator], feature, gt_skin, vert_mask,
                         num_sample: int = 256, margin: float = 0.2, pos_weight: float = 10.0,
                         sim_threshold: float = 0.9) -> torch.Tensor:
    return hinge_embedding_loss_drawn(feature, gt_skin, draw_rows(generator, vert_mask, num_sample),
                                      margin, pos_weight, sim_threshold)


def multi_label_bce(feature: torch.Tensor, seg_onehot: torch.Tensor, vert_mask: torch.Tensor,
                    tau: float = 0.05) -> torch.Tensor:
    """Pairwise same-segment BCE on feature similarities / tau over the
    valid vertex pairs; seg_onehot (B, V, K)."""
    sim = torch.einsum("bvc,bwc->bvw", feature, feature) / tau
    gt = torch.einsum("bvk,bwk->bvw", seg_onehot, seg_onehot)
    m = vert_mask[:, :, None] & vert_mask[:, None, :]
    per = _bce_logits(sim, gt)
    total = torch.where(m, per, torch.zeros_like(per)).sum()
    return total / torch.clamp(batch_sum(m.sum()), min=1.0)


def trans_loss(adj_cost: torch.Tensor, seg_onehot: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean transition cost adj_cost (B, N, N[, T]) over the valid
    same-segment element pairs."""
    gt = torch.einsum("bvk,bwk->bvw", seg_onehot, seg_onehot)
    m = (mask[:, :, None] & mask[:, None, :]).to(adj_cost.dtype) * gt
    steps = 1
    if adj_cost.ndim == 4:
        m, steps = m[..., None], adj_cost.shape[-1]
    return (adj_cost * m).sum() / torch.clamp(batch_sum(m.sum()) * steps, min=1.0)


def motion_loss(pred_Rs: torch.Tensor, pred_ts: torch.Tensor, xyz: torch.Tensor,
                gt_flow: torch.Tensor, gt_seg: torch.Tensor) -> torch.Tensor:
    """Rigid-motion consistency: under each point's predicted rigid motion
    (pred_Rs (B,n,3,3), pred_ts (B,n,3)), the points of its segment must
    land on their own flowed positions."""
    ppdist = xyz[:, None, :, :] - xyz[:, :, None, :]                       # (B,n,n,3)
    moved = (torch.einsum("bnij,bnmj->bnmi", pred_Rs, ppdist) + pred_ts[:, :, None, :]
             + gt_flow[:, :, None, :])
    err = ((moved - gt_flow[:, None, :, :]) ** 2).sum(-1)
    seg = torch.einsum("bnk,bmk->bnm", gt_seg, gt_seg)
    segn = seg / (seg.sum(2, keepdim=True) + 1e-8)
    return (err * segn).sum() / torch.clamp(batch_sum(segn.sum()), min=1e-8)


def grouping_loss(pred_support: torch.Tensor, seg_onehot: torch.Tensor) -> torch.Tensor:
    """BCE between predicted support logits (B,N,N) and same-segment
    indicators."""
    gt = torch.einsum("bnk,bmk->bnm", seg_onehot, seg_onehot)
    return batch_mean(_bce_logits(pred_support, gt))


def hungarian_matching(pred_seg: np.ndarray, gt_seg: np.ndarray) -> np.ndarray:
    """(2, K) matched (pred, gt) segment columns minimizing 1 - IoU (host)."""
    inter = pred_seg.T @ gt_seg
    union = pred_seg.sum(0)[:, None] + gt_seg.sum(0)[None] - inter + 1e-8
    r, c = linear_sum_assignment(1.0 - inter / union)
    return np.stack([r, c])


def iou_loss(pred_seg: torch.Tensor, gt_seg_onehot: torch.Tensor) -> torch.Tensor:
    """1 - soft IoU of the matched segments, averaged: pred_seg (N, Kp) soft
    assignments, gt_seg_onehot (N, Kg), matched on the host."""
    match = hungarian_matching(pred_seg.detach().cpu().numpy(),
                               gt_seg_onehot.detach().cpu().numpy())
    p = pred_seg[:, torch.as_tensor(match[0], device=pred_seg.device)]
    g = gt_seg_onehot[:, torch.as_tensor(match[1], device=pred_seg.device)]
    inter = (p * g).sum(0)
    union = p.sum(0) + g.sum(0) - inter + 1e-8
    return (1.0 - inter / union).mean()


def skin_difference_loss_drawn(pred_skin: torch.Tensor, gt_skin: torch.Tensor,
                               ids: torch.Tensor) -> torch.Tensor:
    """Mean L1 distance between the predicted skin rows of the pairs of rows
    `ids` whose GT rows are equal (within 1e-6), averaged over the batch."""
    ps, gs = _rows(pred_skin, ids), _rows(gt_skin, ids)
    pd = (ps[:, :, None] - ps[:, None]).abs().sum(-1)
    gd = (gs[:, :, None] - gs[:, None]).abs().sum(-1)
    same = (gd.abs() < 1e-6).to(pd.dtype)
    return batch_mean((pd * same).sum((-2, -1)) / torch.clamp(same.sum((-2, -1)), min=1.0))


def skin_difference_loss(generator: Optional[torch.Generator], pred_skin, gt_skin, vert_mask,
                         sample_ratio: float = 0.25) -> torch.Tensor:
    """`skin_difference_loss_drawn` on max(int(V * sample_ratio), 2) rows
    per sample."""
    n = max(int(pred_skin.shape[1] * sample_ratio), 2)
    return skin_difference_loss_drawn(pred_skin, gt_skin, draw_rows(generator, vert_mask, n))
