"""The row-invariant fp32 matrix product (kernel KG, a kernel of the port's
own) and the products of a training step that go through it.

`gemm(a, b, bias)` computes a @ b (+ bias) in fp32 with every output
element summing its K products in one fixed order (csrc/gemm_f32.cu): K
cut into chunks of KC = 64, each chunk's partial an fmaf chain from 0 in k
order, the partials added in chunk order, then the bias.  So a row's bits
do not depend on how many rows, columns or batch entries share the call: a
rank of a data-parallel step computes its rows as the one-device step on
the whole batch does, and a tensor-parallel layer's columns as the whole
layer's.  On a CPU tensor it is `gemm_plain` (`torch.matmul`), the port's
CPU numerics.

`plan(batch, M, N, K, sms)` picks the route from the shape and the card's SM
count, and the C entry launches what it says: "tile" (a block per tile
walks all of K: the 128 x 128 tile where a matrix's tiles fill the card,
smaller ones for batches of small matrices), "split" (where the tiles leave
SMs idle: blocks own (tile, chunk range) pairs, write each chunk's partial
to a workspace, and a second kernel adds them in chunk order) or "tiny"
(one thread per element, matrices of at most TINY elements summing one
chunk).  Every route gives the same bits.  `python -m pytest
tests/test_torch_gemm_plan.py -q` holds the planner on the CPU; on the card
`python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q -k gemm`
holds the kernel, and `chip_smoke.py`'s phase 3 (`check_kg`) times it.

`linear` (nn.mlp.Dense's fp32 x @ W^T + b and the local product of
parallel/mesh.py `tp_linear`) and `bmm` (a batch of products, each sample
its own) take KG on the card in the forward and for the gradients of their
activations; `dot_last` takes it for a per-sample sum of products over the
last axis (a masked mean's numerator), which PyTorch's reduction splits
over more threads when it has fewer rows to sum.  A shared weight's
gradient sums over the rows of the batch, so its order changes with the
rows whatever computes it: it stays `torch.matmul`'s, as do the bias's
sums.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from morig_tpu_torch.kernels import build as kb

KC = 64                       # csrc/gemm_f32.cu's chunk of K, the same for every shape
TINY = 256                    # the tiny route: at most this many elements a matrix, K <= KC
# (BM, BN) of csrc/gemm_f32.cu's tiles, by index: the large tile at two
# blocks per SM; the split route's and the batched small matrices' tiles;
# the large tile at one block per SM
TILES = ((128, 128), (64, 64), (32, 64), (8, 128), (128, 128))
LARGE, LARGE_ONE = 0, 4
ROUTES = ("tiny", "tile", "split")
THREADS = 256                 # of the tiny kernel's and the fold's blocks
MAX_GRID_Z = 65535


class Plan(NamedTuple):
    """How csrc/gemm_f32.cu computes one call.  route: "tiny", "tile" or
    "split"; tile: an index of TILES (-1 on the tiny route); chunks:
    ceil(K / KC); per, splits: the split route's chunks per block and blocks
    per tile and batch entry; grid: the tiny, tile or split kernel's; fold:
    the blocks of the split route's fold; workspace: its bytes (batch x
    chunks x M x N fp32 partials)."""
    route: str
    tile: int
    chunks: int
    per: int
    splits: int
    grid: tuple
    fold: int
    workspace: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)   # a wrapper's host time is most of a small call's
def plan(batch: int, M: int, N: int, K: int, sms: int, route: Optional[str] = None,
         tile: Optional[int] = None) -> Plan:
    """The plan of a (batch,) M x K by K x N product on a card of `sms` SMs.
    One thread per element for matrices of at most TINY elements summing
    one chunk.  The large tile where its tiles keep at least 3/4 of the SMs
    busy: two blocks per SM where they fill the card more than once, else
    one.  Otherwise a tile by M (8 x 128 up to 8 rows, 32 x 64 up to 32,
    else 64 x 64), split over K where its tiles leave SMs idle, into enough
    (tile, chunk range) blocks for one per SM where the chunks allow.
    `route` and `tile` force a route (the split route then gives each chunk
    its own block) and a tile: for tests, which hold that every route gives
    the same bits.  (The C entry moves the large tile's operands that load
    a float at a time, an odd K, to its one-block form: the same bits.)"""
    if route not in (None,) + ROUTES or (tile is not None and not 0 <= tile < len(TILES)):
        raise ValueError(f"gemm plan: no route {route!r} / tile {tile!r}")
    chunks = _cdiv(K, KC)
    count = batch * M * N
    if route == "tiny" or (route is None and M * N <= TINY and K <= KC):
        return Plan("tiny", -1, chunks, 0, 0, (min(_cdiv(count, THREADS), 32 * sms), 1, 1), 0, 0)

    def tiles(t: int) -> int:
        bm, bn = TILES[t]
        return _cdiv(M, bm) * _cdiv(N, bn) * batch

    if tile is None:
        if M > 64 and 4 * tiles(LARGE) >= 3 * sms:
            tile = LARGE if tiles(LARGE) > sms else LARGE_ONE
        else:
            tile = 3 if M <= 8 else 2 if M <= 32 else 1
    bm, bn = TILES[tile]
    forced = route is not None
    if route is None:
        route = ("split" if tile not in (LARGE, LARGE_ONE) and tiles(tile) < sms and chunks > 1
                 else "tile")
    if route == "tile":
        return Plan("tile", tile, chunks, chunks, 1,
                    (_cdiv(N, bn), _cdiv(M, bm), min(batch, MAX_GRID_Z)), 0, 0)
    per = min(1, chunks) if forced else max(1, chunks // _cdiv(sms, tiles(tile)))
    splits = _cdiv(chunks, per) if per else 0
    return Plan("split", tile, chunks, per, splits,
                (_cdiv(N, bn), _cdiv(M, bm), min(batch * splits, MAX_GRID_Z)),
                min(_cdiv(count, THREADS), 32 * sms), 4 * batch * chunks * M * N)


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def gemm_plain(a, b, bias=None):
    """Plain PyTorch version of KG: a (..., M, K) @ b (..., K, N) (+ bias)."""
    y = torch.matmul(a, b)
    return y if bias is None else y + bias


def _operand(t: torch.Tensor, batch: int):
    """t (batch, R, C) or (R, C) (one matrix for the whole batch), fp32:
    (t with unit-free strides, its batch stride, its two matrix strides)."""
    if t.stride(-1) != 1 and t.stride(-2) != 1:
        t = t.contiguous()
    sb = t.stride(0) if t.dim() == 3 else 0
    return t, sb, t.stride(-2), t.stride(-1)


def gemm(a, b, bias=None, route: Optional[str] = None, tile: Optional[int] = None):
    """KG.  a (batch, M, K) or (M, K), b (batch, K, N) or (K, N), both fp32
    (any strides; a matrix with neither axis contiguous is copied), bias
    (N) or None -> (batch, M, N) or (M, N) fp32, contiguous.  `route` and
    `tile` force `plan`'s choice (for tests)."""
    if not a.is_cuda:
        return gemm_plain(a, b, bias)
    if a.dtype != torch.float32 or b.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise TypeError(f"gemm takes fp32 operands, got {a.dtype}, {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"gemm takes (batch,) M x K and (batch,) K x N, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch = a.shape[0] if a.dim() == 3 else (b.shape[0] if b.dim() == 3 else 1)
    if (a.dim() == 3 and a.shape[0] != batch) or (b.dim() == 3 and b.shape[0] != batch):
        raise ValueError(f"gemm: batches {tuple(a.shape)} and {tuple(b.shape)} differ")
    dev = a.device
    if b.device != dev or (bias is not None and (bias.device != dev
                                                 or bias.shape != (b.shape[-1],))):
        raise ValueError("gemm: operands and an (N,) bias on one device")
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(((batch,) if a.dim() == 3 or b.dim() == 3 else ()) + (M, N),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    p = plan(batch, M, N, K, sm_count(dev), route, tile)
    a, sab, sam, sak = _operand(a, batch)
    b, sbb, sbk, sbn = _operand(b, batch)
    bias = bias.contiguous() if bias is not None else None
    ws = (torch.empty(p.workspace // 4, dtype=torch.float32, device=dev) if p.workspace
          else None)
    err = kb.library().gemm_f32(a.data_ptr(), sab, sam, sak, b.data_ptr(), sbb, sbk, sbn,
                                bias.data_ptr() if bias is not None else None, out.data_ptr(),
                                ws.data_ptr() if ws is not None else None, batch, M, N, K,
                                ROUTES.index(p.route), max(p.tile, 0), p.per, p.splits,
                                *p.grid, p.fold, kb.stream(dev))
    kb.check(err, "gemm_f32")
    gemm.launches += 1
    return out


gemm.launches = 0


class _Linear(torch.autograd.Function):
    """y = x @ W^T + b on KG; dx = dy @ W on KG; dW, db torch's sums over
    the rows."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return gemm(x, weight.t(), bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = gemm(dy, weight) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(dy.t(), x) if ctx.needs_input_grad[1] else None
        db = dy.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (..., K) @ weight (N, K)^T (+ bias (N)) computed in `dtype` (inputs,
    weight and bias rounded to it, output in it).  In fp32 on the card KG
    over the rows flattened; otherwise torch.matmul then the bias, as
    nn.mlp.Dense always computed it."""
    x, weight = x.to(dtype), weight.to(dtype)
    bias = bias.to(dtype) if bias is not None else None
    if not (x.is_cuda and dtype == torch.float32):
        y = torch.matmul(x, weight.t())
        return y if bias is None else y + bias
    lead = x.shape[:-1]
    y = _Linear.apply(x.reshape(-1, x.shape[-1]), weight, bias)
    return y.reshape(lead + (weight.shape[0],))


class _Bmm(torch.autograd.Function):
    """c = a @ b per batch entry on KG, both gradients on KG (each a sum
    within one batch entry)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return gemm(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        da = gemm(dc, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        db = gemm(a.transpose(1, 2), dc) if ctx.needs_input_grad[1] else None
        return da, db


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N), the leading axes alike, fp32.  On the
    card KG over the leading axes flattened; on the CPU torch.matmul."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    lead = a.shape[:-2]
    c = _Bmm.apply(a.reshape((-1,) + a.shape[-2:]), b.reshape((-1,) + b.shape[-2:]))
    return c.reshape(lead + c.shape[-2:])


def dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b).sum(-1) for a and b of one shape (..., N), fp32.  On the
    card each row's N products summed in order by KG (`bmm` of (.., 1, N)
    by (.., N, 1)); on the CPU the elementwise product and torch's sum."""
    if not a.is_cuda:
        return (a * b).sum(-1)
    return bmm(a[..., None, :], b[..., :, None])[..., 0, 0]
