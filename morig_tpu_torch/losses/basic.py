"""Masked losses — counterpart of morig_tpu/losses/basic.py: chamfer
distances, soft-label cross-entropy, masked BCE and L1/MSE.  The chamfer
functions take batches (B,N,3) x (B,M,3) and return one value per sample
where the JAX package's take one pair and are vmapped.  Means over the
batch and masked means follow parallel/mesh.py's convention on a mesh
(`batch_mean`, `batch_sum`); without one they are the plain means."""
from __future__ import annotations

from typing import Optional

import torch

from morig_tpu_torch.kernels.gemm import dot_last
from morig_tpu_torch.kernels.neighbors import pairwise_sqdist
from morig_tpu_torch.parallel import batch_mean, batch_sum

POS = 1e30


def _broadcast_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    m = mask.to(like.dtype)
    while m.dim() < like.dim():
        m = m[..., None]
    return m.expand(like.shape)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy with logits over the valid elements."""
    per = torch.relu(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if mask is None:
        return batch_mean(per)
    m = _broadcast_mask(mask, per)
    return (per * m).sum() / torch.clamp(batch_sum(m.sum()), min=1.0)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - target| over the valid elements."""
    m = _broadcast_mask(mask, pred)
    return ((pred - target).abs() * m).sum() / torch.clamp(batch_sum(m.sum()), min=1.0)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean (pred - target)^2 over the valid elements."""
    m = _broadcast_mask(mask, pred)
    return ((pred - target) ** 2 * m).sum() / torch.clamp(batch_sum(m.sum()), min=1.0)


def masked_l1_weighted(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """masked_l1 with a per-element weight of mask's shape: sum(w m |err|) /
    sum(w m dims); masked_l1 at weights 1."""
    m = _broadcast_mask(mask.to(pred.dtype) * weights.to(pred.dtype), pred)
    return ((pred - target).abs() * m).sum() / torch.clamp(batch_sum(m.sum()), min=1.0)


def cross_entropy_with_probs(logits: torch.Tensor, target_probs: torch.Tensor,
                             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-label cross-entropy per element: -target * log_softmax(logits)."""
    losses = -target_probs * torch.log_softmax(logits, dim=-1)
    return losses if weight is None else losses * weight


def _masked_mean(d: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the last axis of (B,N) over mask's entries (all when None)."""
    if mask is None:
        return d.mean(-1)
    m = mask.to(d.dtype)
    return dot_last(d, m) / torch.clamp(m.sum(-1), min=1.0)


def chamfer_directional(p1: torch.Tensor, p2: torch.Tensor,
                        mask1: Optional[torch.Tensor] = None,
                        mask2: Optional[torch.Tensor] = None):
    """The two halves of the chamfer distance per sample of (B,N,3) and
    (B,M,3): (mean over p1 of the euclidean distance to the nearest of p2,
    mean over p2 of the distance to the nearest of p1), each (B,), over the
    valid points of the masks."""
    d = torch.sqrt(torch.clamp(pairwise_sqdist(p1, p2), min=1e-12))
    dm = d if mask2 is None else torch.where(mask2[:, None, :], d, torch.full_like(d, POS))
    mean1 = _masked_mean(dm.amin(2), mask1)
    dt = d if mask1 is None else torch.where(mask1[:, :, None], d, torch.full_like(d, POS))
    mean2 = _masked_mean(dt.amin(1), mask2)
    return mean1, mean2


def chamfer_with_average(p1, p2, mask1=None, mask2=None) -> torch.Tensor:
    """Symmetric mean-of-min chamfer per sample, 0.5 * (mean1 + mean2), (B,)."""
    mean1, mean2 = chamfer_directional(p1, p2, mask1, mask2)
    return 0.5 * (mean1 + mean2)


def batched_chamfer_with_average(p1, p2, mask1, mask2) -> torch.Tensor:
    """Mean over the batch of the per-sample chamfer."""
    return batch_mean(chamfer_with_average(p1, p2, mask1, mask2))
