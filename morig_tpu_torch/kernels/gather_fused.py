"""Batched row gather (kernel K3) — counterpart of
morig_tpu/kernels/gather_fused.py `gather_rows`.

out[b, ...] = values[b, idx[b, ...]], exact.  `gather_rows` launches the
CUDA kernel (csrc/gather_rows.cu) for a CUDA tensor and runs `gather_plain`
for a CPU tensor.
"""
from __future__ import annotations

import torch

from morig_tpu_torch.kernels import build as kb

DTYPES = (torch.float32, torch.int32)


def gather_plain(values, idx):
    """Plain PyTorch version of K3: (B,N,C), (B,...) int64 -> (B,...,C)."""
    bsel = torch.arange(values.shape[0], device=values.device)
    bsel = bsel.reshape((-1,) + (1,) * (idx.dim() - 1))
    return values[bsel, idx]


def gather_rows(values, idx):
    """K3.  Same arguments and result as `gather_plain`."""
    if not values.is_cuda:
        return gather_plain(values, idx)
    if values.dtype not in DTYPES:
        raise TypeError(f"gather kernel takes {DTYPES}, got {values.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError("gather kernel takes int64 indices")
    if idx.device != values.device or idx.shape[0] != values.shape[0]:
        raise ValueError("gather kernel: idx and values must share device and batch")
    B, N, C = values.shape
    lead = idx.shape
    idx2 = idx.reshape(B, -1).contiguous()
    vals = values.contiguous()
    out = torch.empty((B, idx2.shape[1], C), dtype=values.dtype, device=values.device)
    err = kb.library().gather_rows_forward(vals.data_ptr(), idx2.data_ptr(), out.data_ptr(),
                                           B, N, idx2.shape[1], C, kb.stream())
    kb.check(err, "gather_rows_forward")
    gather_rows.launches += 1
    return out.reshape(lead + (C,))


gather_rows.launches = 0
