"""Masked elementwise losses — counterpart of the part of
morig_tpu/losses/basic.py the pose stages use (`bce_with_logits`,
`masked_l1`, `masked_mse`)."""
from __future__ import annotations

from typing import Optional

import torch


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
        return per.mean()
    m = _broadcast_mask(mask, per)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - target| over the valid elements."""
    m = _broadcast_mask(mask, pred)
    return ((pred - target).abs() * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean (pred - target)^2 over the valid elements."""
    m = _broadcast_mask(mask, pred)
    return ((pred - target) ** 2 * m).sum() / torch.clamp(m.sum(), min=1.0)
