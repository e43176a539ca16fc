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
on the card), on a CPU tensor through `index_add_` (`scatter_rows_plain`,
or `row_scatter_plain` over a given table), which adds in the same order.
An atomic scatter such as `index_add_` on the card adds in an order that
changes from run to run; this one makes the backward of K2's gathers, of
`gather_rows_trainable` and the db_table sum of the edge backward K6 repeat
bit for bit.  `plan_scatter` picks the scatter's launch from the shapes
alone (`python -m pytest tests/test_torch_scatter_plan.py -q` holds it on
the CPU).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from morig_tpu_torch.kernels import build as kb
from morig_tpu_torch.kernels.gemm import sm_count

DTYPES = (torch.float32, torch.int32)
INDEX_LIMIT = 2 ** 31         # K3's offsets and the reverse table's short keys are 32-bit


def gather_plain(values, idx):
    """Plain PyTorch version of K3: (B,N,C), (B,...) int64 -> (B,...,C)."""
    bsel = torch.arange(values.shape[0], device=values.device)
    bsel = bsel.reshape((-1,) + (1,) * (idx.dim() - 1))
    return values[bsel, idx]


def _flat_targets(idx, n: int, dtype=torch.int64) -> torch.Tensor:
    B = idx.shape[0]
    return (idx.reshape(B, -1).to(dtype)
            + n * torch.arange(B, device=idx.device, dtype=dtype)[:, None]).reshape(-1)


def scatter_rows_plain(idx, rows, n: int):
    """Plain PyTorch version of the ordered row scatter, the transpose of
    `gather_plain`: (B,...) int64 indices into n rows, (B,...,C) rows ->
    (B,n,C) fp32, each index's rows summed (`index_add_`, which adds them in
    the order of their flat positions on the CPU and in no fixed order on
    the card)."""
    B, C = idx.shape[0], rows.shape[-1]
    out = torch.zeros(B * n, C, dtype=torch.float32, device=rows.device)
    return out.index_add_(0, _flat_targets(idx, n), rows.reshape(-1, C).float()).reshape(B, n, C)


def reverse_table(idx, n: int, mask=None, wide: Optional[bool] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The transpose of (B,...) int64 indices into n rows per batch row, on
    idx's device: (order, offsets), both int64, where order lists the flat
    positions of the (valid, where `mask` (B,...) bool is given) indices,
    stably sorted by their target row b n + idx, and target row r's sources
    are order[offsets[r] : offsets[r + 1]] in their flat order.  The sort's
    keys are 32-bit where every target fits (B n + 1 < 2^31), else 64-bit;
    `wide` forces 64-bit (True) or 32-bit (False) keys, for tests: a stable
    sort gives the same permutation either way.  A MeshBatch builds its
    neighbour tables' once (`MeshBatch.tpl_rev`, `geo_rev`)."""
    B = idx.shape[0]
    if wide is None:
        wide = B * n + 1 >= INDEX_LIMIT
    flat = _flat_targets(idx, n, torch.int64 if wide else torch.int32)
    if mask is not None:
        flat = torch.where(mask.reshape(-1), flat, B * n)
    keys, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(B * n + 1, device=idx.device,
                                                    dtype=keys.dtype))
    return order, offsets


class ScatterPlan(NamedTuple):
    """How csrc/row_scatter.cu computes one call.  route: "vector" (each
    lane loads 16 bytes of a row's channels) or "scalar" (one channel);
    vec: the channels a lane loads at once (16 / element size, or 1); group:
    the lanes that own one target row (a power of two, at most a warp);
    rows_per_warp: 32 / group; passes: sweeps of group x vec channels that
    cover a row; threads: per block; grid: blocks, one group per target row."""
    route: str
    vec: int
    group: int
    rows_per_warp: int
    passes: int
    threads: int
    grid: int


WARP = 32
VECTOR_BYTES = 16
THREADS = (256, 128, 64)      # the block sizes the planner takes, largest first
MIN_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=4096)   # a wrapper's host time is most of a small call's
def plan_scatter(R: int, C: int, elem_size: int, aligned: bool, sms: int) -> ScatterPlan:
    """The launch of the ordered row scatter of R target rows, C channels of
    `elem_size` bytes (4 fp32, 2 bf16), on a card of `sms` SMs: the vector
    route where a row is a whole number of 16-byte vectors and the rows'
    base is 16-byte `aligned`, else the scalar route; a group of lanes the
    smallest power of two that covers a row's vectors (channels on the
    scalar route), at most a warp, wider rows swept in passes; the largest
    block (256, 128, 64 threads) that still gives MIN_BLOCKS_PER_SM blocks
    per SM, else 64, so few target rows still spread over the card."""
    if R < 0 or C < 1 or elem_size not in (2, 4):
        raise ValueError(f"scatter plan: R={R}, C={C}, element size {elem_size}")
    vector = aligned and C * elem_size % VECTOR_BYTES == 0
    vec = VECTOR_BYTES // elem_size if vector else 1
    lanes = C // vec
    group = min(WARP, 1 << (lanes - 1).bit_length())
    passes = -(-lanes // group)
    for threads in THREADS:
        grid = -(-R * group // threads)
        if grid >= MIN_BLOCKS_PER_SM * sms:
            break
    if grid >= INDEX_LIMIT:
        raise ValueError(f"scatter plan: {R} target rows need {grid} blocks")
    return ScatterPlan("vector" if vector else "scalar", vec, group, WARP // group, passes,
                       threads, grid)


def row_scatter_plain(rows, order, offsets, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of one launch of the ordered row scatter: rows
    (E, C), a reverse table -> (n_out, C) fp32, target row r the sum of
    rows[order[k]] for k in offsets[r] .. offsets[r + 1] - 1 (`index_add_`
    in k order, sequential on the CPU)."""
    target = torch.repeat_interleave(torch.arange(n_out, device=rows.device), offsets.diff())
    out = torch.zeros(n_out, rows.shape[1], dtype=torch.float32, device=rows.device)
    return out.index_add_(0, target, rows[order[:target.numel()]].float())


def row_scatter_launch(rows, order, offsets, n_out: int, edge_db: bool = False) -> torch.Tensor:
    """One launch of the ordered row scatter on the card: rows (E, C) fp32 or
    bf16, a reverse table, -> (n_out, C) fp32, launched as `plan_scatter`
    says.  `edge_db` (bf16 rows): the launch K6 makes for its db_table,
    under a kernel name of its own.  Uncounted: its callers count
    (`scatter_rows`, and K6 as one of its launches).  On a CPU tensor
    `row_scatter_plain`."""
    if not rows.is_cuda:
        return row_scatter_plain(rows, order, offsets, n_out)
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
    C = rows.shape[1]
    out = torch.empty((n_out, C), dtype=torch.float32, device=rows.device)
    if out.numel() == 0:
        return out
    p = plan_scatter(n_out, C, rows.element_size(), rows.data_ptr() % VECTOR_BYTES == 0,
                     sm_count(rows.device))
    err = kb.library().row_scatter(rows.data_ptr(), int(rows.dtype == torch.bfloat16),
                                   int(edge_db), order.data_ptr(), offsets.data_ptr(),
                                   out.data_ptr(), n_out, C, int(p.route == "vector"), p.group,
                                   p.passes, p.threads, p.grid, kb.stream(rows.device))
    kb.check(err, "row_scatter")
    return out


def scatter_rows(idx, rows, n: int, rev=None):
    """The ordered row scatter.  Same arguments and result as
    `scatter_rows_plain`; `rev`: `reverse_table(idx, n)` where the caller
    has it (K2's backward builds one for its two scatters).  On a CUDA
    tensor one launch of the kernel over that table (built here when not
    given), the sum in the same order as the CPU's; on a CPU tensor
    `scatter_rows_plain`, or `row_scatter_plain` over a given table."""
    B, C = idx.shape[0], rows.shape[-1]
    if not rows.is_cuda:
        if rev is None:
            return scatter_rows_plain(idx, rows, n)
        return row_scatter_plain(rows.reshape(-1, C), *rev, B * n).reshape(B, n, C)
    if idx.dtype != torch.int64 or idx.device != rows.device or rows.shape[:-1] != idx.shape:
        raise ValueError("row scatter takes int64 (B,...) indices and (B,...,C) rows on one device")
    order, offsets = rev if rev is not None else reverse_table(idx, n)
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
