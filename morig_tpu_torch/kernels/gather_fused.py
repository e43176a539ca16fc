"""Batched row gather (kernel K3) — counterpart of
morig_tpu/kernels/gather_fused.py `gather_rows` — and its transpose, the
ordered row scatter (a kernel of the port's own).

out[b, ...] = values[b, idx[b, ...]], exact.  `gather_rows` launches the
CUDA kernel (csrc/gather_rows.cu) for a CUDA tensor and runs `gather_plain`
for a CPU tensor.

`scatter_rows` sums rows into the rows their indices name, each target row
adding its sources in the order of their flat positions, on every run:
on a CUDA tensor through the ordered row scatter (csrc/row_scatter.cu) over
a reverse table (`reverse_table`: a stable sort of the flat indices, built
on the card), on a CPU tensor through `index_add_` (`scatter_rows_plain`),
which adds in the same order.  An atomic scatter such as `index_add_` on the
card adds in an order that changes from run to run; this one makes the
backward of K2's gathers, of `gather_rows_trainable` and the db_table sum of
the edge backward K6 repeat bit for bit.
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


def _flat_targets(idx, n: int) -> torch.Tensor:
    B = idx.shape[0]
    return (idx.reshape(B, -1) + n * torch.arange(B, device=idx.device)[:, None]).reshape(-1)


def scatter_rows_plain(idx, rows, n: int):
    """Plain PyTorch version of the ordered row scatter, the transpose of
    `gather_plain`: (B,...) int64 indices into n rows, (B,...,C) rows ->
    (B,n,C) fp32, each index's rows summed (`index_add_`, which adds them in
    the order of their flat positions on the CPU and in no fixed order on
    the card)."""
    B, C = idx.shape[0], rows.shape[-1]
    out = torch.zeros(B * n, C, dtype=torch.float32, device=rows.device)
    return out.index_add_(0, _flat_targets(idx, n), rows.reshape(-1, C).float()).reshape(B, n, C)


def reverse_table(idx, n: int, mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The transpose of (B,...) int64 indices into n rows per batch row, on
    idx's device: (order, offsets), where order lists the flat positions of
    the (valid, where `mask` (B,...) bool is given) indices, stably sorted by
    their target row b n + idx, and target row r's sources are order[
    offsets[r] : offsets[r + 1]] in their flat order.  A MeshBatch builds
    its neighbour tables' once (`MeshBatch.tpl_rev`, `geo_rev`)."""
    B = idx.shape[0]
    flat = _flat_targets(idx, n)
    if mask is not None:
        flat = torch.where(mask.reshape(-1), flat, torch.full_like(flat, B * n))
    keys, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(B * n + 1, device=idx.device))
    return order, offsets


def row_scatter_launch(rows, order, offsets, n_out: int, edge_db: bool = False) -> torch.Tensor:
    """One launch of the ordered row scatter on the card: rows (E, C) fp32 or
    bf16, a reverse table, -> (n_out, C) fp32.  `edge_db` (bf16 rows): the
    launch K6 makes for its db_table, under a kernel name of its own.
    Uncounted: its callers count (`scatter_rows`, and K6 as one of its
    launches)."""
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"row scatter takes fp32 or bf16 rows, got {rows.dtype}")
    if edge_db and rows.dtype != torch.bfloat16:
        raise TypeError("K6's db_table sum takes bf16 rows")
    if offsets.numel() != n_out + 1 or rows.dim() != 2:
        raise ValueError("row scatter: (E, C) rows and n_out + 1 offsets")
    for t in (order, offsets):
        if t.device != rows.device or t.dtype != torch.int64:
            raise ValueError("row scatter: int64 order and offsets on the rows' device")
    rows = rows.contiguous()
    out = torch.empty((n_out, rows.shape[1]), dtype=torch.float32, device=rows.device)
    err = kb.library().row_scatter(rows.data_ptr(), int(rows.dtype == torch.bfloat16),
                                   int(edge_db), order.data_ptr(), offsets.data_ptr(),
                                   out.data_ptr(), n_out, rows.shape[1], kb.stream(rows.device))
    kb.check(err, "row_scatter")
    return out


def scatter_rows(idx, rows, n: int):
    """The ordered row scatter.  Same arguments and result as
    `scatter_rows_plain`; on a CUDA tensor one launch of the kernel over
    `reverse_table(idx, n)`, the sum in the same order as the CPU's."""
    if not rows.is_cuda:
        return scatter_rows_plain(idx, rows, n)
    B, C = idx.shape[0], rows.shape[-1]
    if idx.dtype != torch.int64 or idx.device != rows.device or rows.shape[:-1] != idx.shape:
        raise ValueError("row scatter takes int64 (B,...) indices and (B,...,C) rows on one device")
    order, offsets = reverse_table(idx, n)
    rows = rows.reshape(-1, C)
    out = row_scatter_launch(rows if rows.dtype == torch.bfloat16 else rows.float(), order,
                             offsets, B * n)
    scatter_rows.launches += 1
    return out.reshape(B, n, C)


scatter_rows.launches = 0


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


class _TrainableGather(torch.autograd.Function):
    """K3 forward; backward the ordered row scatter into values' rows."""

    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.n = values.shape[1]
        return gather_rows(values, idx)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return scatter_rows(idx, dout, ctx.n), None


def gather_rows_trainable(values, idx):
    """`gather_rows` with a gradient that repeats bit for bit: forward K3
    (fp32 values), backward `scatter_rows`.  On a CPU tensor the plain
    versions of both."""
    return _TrainableGather.apply(values, idx)
