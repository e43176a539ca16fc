"""Batched cosine kNN with row gather (kernel K2) — counterpart of
morig_tpu/kernels/knn_fused.py `knn_batched(..., gather_values=...)`.

Semantics (the TPU kernel's): score = <q, c> with bf16 operands and fp32
accumulation; masked candidates score -1e30; the k largest in
first-index-wins order; once a row has fewer than k valid candidates the
remaining slots hold index 0 and score -1e30 (an all-masked row returns
index 0 everywhere); gathered = values[idx] exactly.

`knn_batched` launches the CUDA kernel (csrc/knn_topk.cu) for a CUDA tensor
and runs `knn_plain` for a CPU tensor.
"""
from __future__ import annotations

import torch

from morig_tpu_torch.kernels import build as kb

NEG = -1e30
MAX_K = 8
FEATURE_WIDTHS = (64,)             # the embedding width of CorrNet, the one caller


def knn_plain(query, cand, k: int, cand_mask, values):
    """Plain PyTorch version of K2: k first-index-wins argmax sweeps over the
    (B,N,P) similarity.  Returns idx (B,N,k) int64, score (B,N,k) fp32,
    gathered (B,N,k,Cv) fp32."""
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
    bsel = torch.arange(values.shape[0], device=values.device)[:, None, None]
    return idx, score, values.float()[bsel, idx]


def knn_batched(query, cand, k: int, cand_mask=None, *, gather_values):
    """K2.  query (B,N,C), cand (B,P,C), cand_mask (B,P) bool or None,
    gather_values (B,P,Cv) -> (idx, score, gathered) as `knn_plain`."""
    if cand_mask is None:
        cand_mask = torch.ones(cand.shape[:2], dtype=torch.bool, device=cand.device)
    if not query.is_cuda:
        return knn_plain(query, cand, k, cand_mask, gather_values)
    B, N, C = query.shape
    P = cand.shape[1]
    Cv = gather_values.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn kernel takes 1 <= k <= {MAX_K}, got {k}")
    if C not in FEATURE_WIDTHS:
        raise ValueError(f"knn kernel takes feature widths {FEATURE_WIDTHS}, got {C}")
    if (cand.shape != (B, P, C) or cand_mask.shape != (B, P)
            or gather_values.shape[:2] != (B, P)):
        raise ValueError("knn kernel: shape mismatch")
    if cand_mask.dtype != torch.bool:
        raise TypeError("knn kernel takes a bool candidate mask")
    args = [query.to(torch.bfloat16).contiguous(), cand.to(torch.bfloat16).contiguous(),
            cand_mask.contiguous(), gather_values.float().contiguous()]
    for t in args:
        if t.device != query.device:
            raise ValueError("knn kernel: all tensors must be on one device")
    idx = torch.empty((B, N, k), dtype=torch.int64, device=query.device)
    score = torch.empty((B, N, k), dtype=torch.float32, device=query.device)
    gathered = torch.empty((B, N, k, Cv), dtype=torch.float32, device=query.device)
    err = kb.library().knn_topk_gather(
        *(t.data_ptr() for t in args), idx.data_ptr(), score.data_ptr(), gathered.data_ptr(),
        B, N, P, C, Cv, k, kb.stream())
    kb.check(err, "knn_topk_gather")
    knn_batched.launches += 1
    return idx, score, gathered


knn_batched.launches = 0
