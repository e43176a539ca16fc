"""Batched cosine kNN with row gather (kernel K2) and without (kernel K4) —
counterpart of morig_tpu/kernels/knn_fused.py `knn_batched`.

Semantics (the TPU kernel's): score = <q, c> with bf16 operands and fp32
accumulation; masked candidates score -1e30; the k largest in
first-index-wins order; once a row has fewer than k valid candidates the
remaining slots hold index 0 and score -1e30 (an all-masked row returns
index 0 everywhere); gathered = values[idx] exactly.

`knn_batched` with `gather_values` launches K2, without it `knn_topk` (K4);
both are csrc/knn_topk.cu's `knn_wgmma_kernel` (the similarity on wgmma,
the top-k in registers, one instantiation for each k), and on a CPU tensor
both run `knn_plain`.  With `gather_values`, gradients flow as in the JAX package's
custom VJP (`_fused_g_bwd`): into the query and the selected candidate rows
through the score, and into the selected value rows through the gathered
values; the selection itself carries none.  The backward is plain PyTorch,
as the JAX VJP is plain XLA.
"""
from __future__ import annotations

import torch

from morig_tpu_torch.kernels import build as kb
from morig_tpu_torch.kernels.gather_fused import scatter_rows

NEG = -1e30
MAX_K = 8
FEATURE_WIDTHS = (64,)             # the embedding width of CorrNet, the one caller


def knn_plain(query, cand, k: int, cand_mask, values=None):
    """Plain PyTorch version of K2 and K4: k first-index-wins argmax sweeps
    over the (B,N,P) similarity.  Returns idx (B,N,k) int64, score (B,N,k)
    fp32 and, with values (B,P,Cv), gathered (B,N,k,Cv) fp32."""
    q = query.to(torch.bfloat16).float()
    c = cand.to(torch.bfloat16).float()
    sim = torch.matmul(q, c.transpose(1, 2))
    sim = torch.where(cand_mask[:, None, :], sim, torch.full_like(sim, NEG))
    idxs, scores = [], []
    for _ in range(k):
        smax, imax = sim.max(dim=-1)          # first index among equal maxima
        imax = torch.where(smax > NEG / 2, imax, torch.zeros_like(imax))
        smax = torch.where(smax > NEG / 2, smax, torch.full_like(smax, NEG))
        idxs.append(imax)
        scores.append(smax)
        sim = sim.scatter(-1, imax[..., None], NEG)
    idx = torch.stack(idxs, -1)
    score = torch.stack(scores, -1)
    if values is None:
        return idx, score
    bsel = torch.arange(values.shape[0], device=values.device)[:, None, None]
    return idx, score, values.float()[bsel, idx]


def _check(query, cand, k: int, cand_mask) -> None:
    B, N, C = query.shape
    P = cand.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn kernel takes 1 <= k <= {MAX_K}, got {k}")
    if C not in FEATURE_WIDTHS:
        raise ValueError(f"knn kernel takes feature widths {FEATURE_WIDTHS}, got {C}")
    if cand.shape != (B, P, C) or cand_mask.shape != (B, P):
        raise ValueError("knn kernel: shape mismatch")
    if cand_mask.dtype != torch.bool:
        raise TypeError("knn kernel takes a bool candidate mask")
    for t in (cand, cand_mask):
        if t.device != query.device:
            raise ValueError("knn kernel: all tensors must be on one device")


def _aligned_bf16(x):
    """x as contiguous bf16 whose base is 16-byte aligned: the kernel copies
    candidate rows in 16-byte pieces (a view that is not gets copied)."""
    x = x.to(torch.bfloat16).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _outputs(query, cand, k, cand_mask):
    B, N, _ = query.shape
    inputs = [_aligned_bf16(query), _aligned_bf16(cand), cand_mask.contiguous()]
    idx = torch.empty((B, N, k), dtype=torch.int64, device=query.device)
    score = torch.empty((B, N, k), dtype=torch.float32, device=query.device)
    return inputs, idx, score


def knn_topk(query, cand, k: int, cand_mask):
    """K4.  query (B,N,C), cand (B,P,C), cand_mask (B,P) bool -> (idx, score)
    as `knn_plain` without values."""
    if not query.is_cuda:
        return knn_plain(query, cand, k, cand_mask)
    _check(query, cand, k, cand_mask)
    (q, c, m), idx, score = _outputs(query, cand, k, cand_mask)
    B, N, C = query.shape
    err = kb.library().knn_topk(q.data_ptr(), c.data_ptr(), m.data_ptr(), idx.data_ptr(),
                                score.data_ptr(), B, N, cand.shape[1], C, k,
                                kb.stream(query.device))
    kb.check(err, "knn_topk")
    knn_topk.launches += 1
    return idx, score


knn_topk.launches = 0


class _KnnGather(torch.autograd.Function):
    """K2 with the JAX package's VJP: score_j = <q, c[idx_j]> and
    gathered_j = values[idx_j] are differentiated at the selected rows."""

    @staticmethod
    def forward(ctx, query, cand, cand_mask, values, k: int):
        idx, score, gathered = _knn_gather(query, cand, k, cand_mask, values)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(query, cand, idx)
        ctx.n_values = values.shape[1]
        return idx, score, gathered

    @staticmethod
    def backward(ctx, _d_idx, d_score, d_gathered):
        query, cand, idx = ctx.saved_tensors
        bsel = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        d_score = d_score.to(query.dtype)
        dq = torch.einsum("bnk,bnkc->bnc", d_score, cand[bsel, idx])
        dc = scatter_rows(idx, d_score[..., None] * query[:, :, None, :], cand.shape[1])
        dvals = scatter_rows(idx, d_gathered, ctx.n_values)
        return dq, dc.to(cand.dtype), None, dvals, None


def _knn_gather(query, cand, k: int, cand_mask, values):
    """K2 (or its plain version on a CPU tensor), without gradients."""
    if not query.is_cuda:
        return knn_plain(query, cand, k, cand_mask, values)
    _check(query, cand, k, cand_mask)
    if values.shape[:2] != cand.shape[:2] or values.device != query.device:
        raise ValueError("knn kernel: gather_values must be (B, P, Cv) on the query's device")
    (q, c, m), idx, score = _outputs(query, cand, k, cand_mask)
    B, N, C = query.shape
    Cv = values.shape[-1]
    vals = values.float().contiguous()
    gathered = torch.empty((B, N, k, Cv), dtype=torch.float32, device=query.device)
    err = kb.library().knn_topk_gather(
        q.data_ptr(), c.data_ptr(), m.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        score.data_ptr(), gathered.data_ptr(), B, N, cand.shape[1], C, Cv, k,
        kb.stream(query.device))
    kb.check(err, "knn_topk_gather")
    knn_batched.launches += 1
    return idx, score, gathered


def knn_batched(query, cand, k: int, cand_mask=None, *, gather_values=None):
    """query (B,N,C), cand (B,P,C), cand_mask (B,P) bool or None.  With
    gather_values (B,P,Cv), K2: (idx, score, gathered) as `knn_plain`,
    differentiable; without, K4 (`knn_topk`): (idx, score)."""
    if cand_mask is None:
        cand_mask = torch.ones(cand.shape[:2], dtype=torch.bool, device=cand.device)
    if gather_values is None:
        return knn_topk(query, cand, k, cand_mask)
    return _KnnGather.apply(query, cand, cand_mask, gather_values, k)


knn_batched.launches = 0
