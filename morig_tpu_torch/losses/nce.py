"""Contrastive losses, batched and masked — counterpart of
morig_tpu/losses/nce.py: the correspondence infoNCE (`info_nce`) and the
multi-positive skin-similarity infoNCE of the rig and skin stages, split
into its draw (`draw_multi_pos`, from a torch.Generator) and the loss on
the drawn indices (`multi_pos_info_nce_drawn`).

The gathers that carry a gradient (anchor rows, the logits of drawn
positives and negatives) run through `gather_rows_trainable`: K3 forward and
the ordered row scatter backward, so a training step repeats bit for bit;
`torch.gather`'s backward on the card adds the gradients of a repeated
index in no fixed order."""
from __future__ import annotations

from typing import Optional

import torch

from morig_tpu_torch.kernels.gather_fused import gather_rows_trainable

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


def _takes_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _rows(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,V,C), (B,N) -> (B,N,C)."""
    if _takes_grad(feature):
        return gather_rows_trainable(feature, idx.long())
    return torch.gather(feature, 1, idx.long()[..., None].expand(-1, -1, feature.shape[-1]))


def _take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """torch.gather(x, -1, idx) for (B,S,M) x and (B,S,K) idx."""
    if not _takes_grad(x):
        return torch.gather(x, -1, idx)
    B, S, M = x.shape
    return gather_rows_trainable(x.reshape(B * S, M, 1), idx.reshape(B * S, -1)).reshape(idx.shape)


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


def _skin_pairs(gt_skin, vert_mask, ids, sim_threshold: float):
    """For the drawn anchors ids (B,S): (row_ok (B,S), pos_mat, neg_mat
    (B,S,S) float).  Two rows are positives where their skin vectors agree
    (L1 similarity (2 - |s_i - s_j|_1) / 2 above the threshold); padded rows
    are neither positives nor negatives of anyone."""
    row_ok = torch.gather(vert_mask, 1, ids)
    s = _rows(gt_skin, ids)
    gt_sim = (2.0 - (s[:, None, :, :] - s[:, :, None, :]).abs().sum(-1)) / 2.0
    ok = row_ok[:, None, :].float()
    pos_mat = (gt_sim > sim_threshold).float()
    return row_ok, pos_mat * ok, (1.0 - pos_mat) * ok


def _choice(p: torch.Tensor, n: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """n draws with replacement from each row of p (..., S), by the inverse
    of the cumulative sum as jax.random.choice draws; a row of zeros gives
    index S - 1."""
    cdf = torch.cumsum(p, -1)
    u = torch.rand(p.shape[:-1] + (n,), generator=generator, device=p.device)
    r = cdf[..., -1:] * (1.0 - u)
    return torch.searchsorted(cdf, r).clamp(max=p.shape[-1] - 1)


def draw_rows(generator: Optional[torch.Generator], vert_mask: torch.Tensor,
              num_sample: int) -> torch.Tensor:
    """(B, num_sample) int64: per sample, num_sample distinct rows drawn
    uniformly among the valid ones of vert_mask (B, V) by Gumbel top-k, as
    jax.random.choice(replace=False, p=mask / sum) draws; past the valid
    count the draw runs into padded rows."""
    p = vert_mask.float()
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1.0)
    u = torch.rand(p.shape, generator=generator, device=p.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.topk(torch.log(p) + gumbel, num_sample, dim=-1).indices


def draw_multi_pos(generator: Optional[torch.Generator], gt_skin: torch.Tensor,
                   vert_mask: torch.Tensor, num_sample: int = 512, num_pos: int = 10,
                   num_neg: int = 200, sim_threshold: float = 0.9):
    """The random draw of `multi_pos_info_nce`, on the tensors' device: per
    sample num_sample distinct anchors among the valid vertices (Gumbel top-k;
    past the valid count the draw runs into padded rows, which the loss
    drops), then per anchor num_pos positives and num_neg negatives with
    replacement.  Returns (ids (B,S), pos_ids (B,S,num_pos), neg_ids
    (B,S,num_neg)), int64."""
    ids = draw_rows(generator, vert_mask, num_sample)
    _, pos_mat, neg_mat = _skin_pairs(gt_skin, vert_mask, ids, sim_threshold)
    pos_p = pos_mat / torch.clamp(pos_mat.sum(-1, keepdim=True), min=1e-9)
    neg_p = neg_mat / torch.clamp(neg_mat.sum(-1, keepdim=True), min=1e-9)
    return ids, _choice(pos_p, num_pos, generator), _choice(neg_p, num_neg, generator)


def multi_pos_info_nce_drawn(feature: torch.Tensor, gt_skin: torch.Tensor,
                             vert_mask: torch.Tensor, ids: torch.Tensor, pos_ids: torch.Tensor,
                             neg_ids: torch.Tensor, sim_threshold: float = 0.9) -> torch.Tensor:
    """The multi-positive infoNCE on drawn indices: per anchor, the mean over
    its positives of the cross-entropy of the positive logit against the
    negatives' (logits are feature inner products); anchors that are padded
    rows or have no negative add nothing; the per-sample sum over anchors
    divided by their count, averaged over the batch."""
    row_ok, _, neg_mat = _skin_pairs(gt_skin, vert_mask, ids, sim_threshold)
    f = _rows(feature, ids)
    prod = torch.matmul(f, f.transpose(1, 2))                            # (B,S,S)
    prod_pos = _take_last(prod, pos_ids)
    lse_neg = torch.logsumexp(_take_last(prod, neg_ids), -1, keepdim=True)
    ce = torch.logaddexp(prod_pos, lse_neg) - prod_pos                   # (B,S,num_pos)
    ok = (neg_mat.sum(-1) > 0) & row_ok
    ce = torch.where(ok[..., None], ce, torch.zeros_like(ce))
    return (ce.mean(-1).sum(-1) / torch.clamp(ok.sum(-1), min=1)).mean()


def multi_pos_info_nce(generator: Optional[torch.Generator], feature: torch.Tensor,
                       gt_skin: torch.Tensor, vert_mask: torch.Tensor, num_sample: int = 512,
                       num_pos: int = 10, num_neg: int = 200,
                       sim_threshold: float = 0.9) -> torch.Tensor:
    """Multi-positive skin-similarity infoNCE: feature (B,V,C), gt_skin
    (B,V,J), vert_mask (B,V) bool; the draw from `generator`."""
    ids, pos_ids, neg_ids = draw_multi_pos(generator, gt_skin, vert_mask, num_sample, num_pos,
                                           num_neg, sim_threshold)
    return multi_pos_info_nce_drawn(feature, gt_skin, vert_mask, ids, pos_ids, neg_ids,
                                    sim_threshold)
