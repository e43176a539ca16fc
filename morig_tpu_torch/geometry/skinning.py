"""Skinning post-processing — counterpart of morig_tpu/geometry/skinning.py,
batched: one-ring smoothing, pruning, renormalization."""
from __future__ import annotations

import torch


def post_filter_skin(skin: torch.Tensor, tpl_nbr: torch.Tensor, tpl_mask: torch.Tensor,
                     num_ring: int = 1) -> torch.Tensor:
    """skin (B,V,M): each vertex's weights become the mean of its ring
    neighbors (self excluded), num_ring times; vertices with no neighbor
    keep theirs."""
    nbr_mask = tpl_mask.clone()
    nbr_mask[..., 0] = False
    m = nbr_mask[..., None].to(skin.dtype)                     # (B,V,D,1)
    has_nbr = nbr_mask.any(-1, keepdim=True)
    bsel = torch.arange(skin.shape[0], device=skin.device)[:, None, None]
    for _ in range(num_ring):
        gathered = skin[bsel, tpl_nbr]                         # (B,V,D,M)
        smoothed = (gathered * m).sum(2) / torch.clamp(m.sum(2), min=1e-10)
        skin = torch.where(has_nbr, smoothed, skin)
    return skin


def prune_and_normalize(skin: torch.Tensor, prune_ratio: float = 0.35) -> torch.Tensor:
    """Zero weights below prune_ratio x row max, renormalize rows."""
    mx = skin.max(-1, keepdim=True).values
    kept = torch.where(skin < mx * prune_ratio, torch.zeros_like(skin), skin)
    return kept / (kept.sum(-1, keepdim=True) + 1e-10)
