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
INDEX_LIMIT = 2 ** 31         # the kernel's offsets are 32-bit


def gather_plain(values, idx):
    """Plain PyTorch version of K3: (B,N,C), (B,...) int64 -> (B,...,C)."""
    bsel = torch.arange(values.shape[0], device=values.device)
    bsel = bsel.reshape((-1,) + (1,) * (idx.dim() - 1))
    return values[bsel, idx]


def scatter_rows(idx, rows, n: int):
    """The transpose of `gather_plain`: (B,...) int64 indices into n rows,
    (B,...,C) rows -> (B,n,C) fp32, each index's rows summed (index_add_)."""
    B, C = idx.shape[0], rows.shape[-1]
    flat = (idx.reshape(B, -1) + n * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    out = torch.zeros(B * n, C, dtype=torch.float32, device=rows.device)
    return out.index_add_(0, flat, rows.reshape(-1, C).float()).reshape(B, n, C)


def gather_rows(values, idx):
    """K3.  Same arguments and result as `gather_plain`.  Rows whose width is
    a multiple of 4 and whose base is 16-byte aligned take the kernel's
    16-byte route, others its 4-byte route; an empty `idx` launches nothing."""
    if not values.is_cuda:
        return gather_plain(values, idx)
    if values.dtype not in DTYPES:
        raise TypeError(f"gather kernel takes {DTYPES}, got {values.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError("gather kernel takes int64 indices")
    dev = values.device
    if idx.device != dev or idx.shape[0] != values.shape[0]:
        raise ValueError("gather kernel: idx and values must share device and batch")
    B, N, C = values.shape
    M = idx.numel() // B if B else 0
    if max(B * N * C, B * M * C) >= INDEX_LIMIT:
        raise ValueError(f"gather kernel takes fewer than 2^31 elements, got values "
                         f"{tuple(values.shape)} and {B * M} indices")
    out = torch.empty(idx.shape + (C,), dtype=values.dtype, device=dev)
    if out.numel() == 0:
        return out
    vals, idx = values.contiguous(), idx.contiguous()
    vec = int(C % 4 == 0 and vals.data_ptr() % 16 == 0)
    err = kb.library().gather_rows_forward(vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                           B, N, M, C, vec, kb.stream(dev))
    kb.check(err, "gather_rows_forward")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
