"""Contrastive losses, batched and masked — counterpart of the part of
morig_tpu/losses/nce.py the correspondence stage uses (`info_nce`)."""
from __future__ import annotations

import torch

NEG = -1e30


def _masked_ce_rows(logits: torch.Tensor, labels: torch.Tensor,
                    row_mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the valid rows of (B,N,M) logits (columns
    already masked to NEG) with (B,N) labels; (B,) per sample, 0 where a
    sample has no valid row."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = logz - picked
    num = torch.where(row_mask, ce, torch.zeros_like(ce)).sum(-1)
    den = row_mask.sum(-1).to(ce.dtype)
    return torch.where(den > 0, num / torch.clamp(den, min=1.0), torch.zeros_like(num))


def _rows(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,V,C), (B,N) -> (B,N,C)."""
    return torch.gather(feature, 1, idx.long()[..., None].expand(-1, -1, feature.shape[-1]))


def info_nce(vtx_feature, pts_feature, corr_v2p, corr_v2p_mask, corr_p2v, corr_p2v_mask,
             vert_mask, pts_mask, tau) -> torch.Tensor:
    """Symmetric correspondence infoNCE.  v2p: anchor = the vertex feature at
    corr_v2p[..., 0], classes = every valid point of the sample, label =
    corr_v2p[..., 1]; p2v symmetrically.  Per-sample mean CE per direction,
    the two directions summed, then averaged over the batch.  Features
    (B,V,C) and (B,P,C) are L2-normalized; tau is the learnable
    temperature."""
    anchors_v = _rows(vtx_feature, corr_v2p[..., 0])
    logits_v = torch.einsum("bnc,bpc->bnp", anchors_v, pts_feature) / tau
    logits_v = torch.where(pts_mask[:, None, :], logits_v, torch.full_like(logits_v, NEG))
    loss_v = _masked_ce_rows(logits_v, corr_v2p[..., 1], corr_v2p_mask)

    anchors_p = _rows(pts_feature, corr_p2v[..., 0])
    logits_p = torch.einsum("bmc,bvc->bmv", anchors_p, vtx_feature) / tau
    logits_p = torch.where(vert_mask[:, None, :], logits_p, torch.full_like(logits_p, NEG))
    loss_p = _masked_ce_rows(logits_p, corr_p2v[..., 1], corr_p2v_mask)
    return (loss_v + loss_p).mean()
