"""Fused EdgeMLP tail (kernels K1 and K5) and its backward (kernel K6) —
counterpart of morig_tpu/kernels/edge_fused.py.

Per vertex v over its D table edges:

    out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))

and 0 where no edge of v is valid.  a and b arrive rounded to bf16; the W2
product takes bf16 operands with fp32 accumulation; both LayerNorms run in
fp32 (eps 1e-6, variance E[x^2] - E[x]^2) over the true width.

K1 (`fused_edge_mlp`) reads each neighbour row from the whole table; K5
(`fused_edge_mlp_windowed`) reads it from its vertex tile's window of
3 tiles, for meshes whose neighbours are local (`check_neighbor_locality`).
K6 (`fused_edge_mlp_bwd`) is K1's one-pass backward with an in-kernel
recompute of the forward, and `fused_edge_mlp_trainable` the autograd
Function whose forward is K1 and whose backward is K6 (the training path).
Each launches its CUDA kernel (csrc/edge_mlp.cu, csrc/edge_mlp_bwd.cu) for a
CUDA tensor and runs its plain version (`edge_mlp_plain`,
`edge_mlp_windowed_plain`, `edge_mlp_bwd_plain`) for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from morig_tpu_torch.kernels import build as kb
from morig_tpu_torch.kernels.gather_fused import scatter_rows

LN_EPS = 1e-6
MAX_DEGREE = 16
WIDTHS = (16, 32, 64, 128, 256)


def _ln_parts(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(xn, inv) of an fp32 LayerNorm over the last axis: inv = rsqrt(var +
    eps) with var = max(E[x^2] - E[x]^2, 0), xn = (h - mu) * inv."""
    h = h.float()
    mu = h.mean(-1, keepdim=True)
    var = torch.clamp((h * h).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + LN_EPS)
    return (h - mu) * inv, inv


def layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis with flax's statistics: var =
    max(E[x^2] - E[x]^2, 0), eps 1e-6."""
    return _ln_parts(h)[0] * scale + bias


def _ln_bwd(dy, scale, xn, inv):
    """Gradient with respect to a LayerNorm's input given its output's."""
    dxn = dy * scale
    m1 = dxn.mean(-1, keepdim=True)
    m2 = (dxn * xn).mean(-1, keepdim=True)
    return (dxn - m1 - xn * m2) * inv


def _edge_tail(a, gathered, mask, w2, b2, g1, be1, g2, be2):
    h = torch.relu(a.float()[:, :, None, :] + gathered)
    h = layer_norm(h, g1, be1)
    h2 = torch.matmul(h.to(torch.bfloat16).float(), w2.to(torch.bfloat16).float()) + b2
    h2 = layer_norm(torch.relu(h2), g2, be2)
    h2 = torch.where(mask[..., None], h2, torch.full_like(h2, -1e30))
    out = h2.max(dim=2).values
    return torch.where(mask.any(dim=2)[..., None], out, torch.zeros_like(out))


def _gather(b, nbr):
    bsel = torch.arange(b.shape[0], device=b.device)[:, None, None]
    return b.float()[bsel, nbr]                                # (B,V,D,H1)


def edge_mlp_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """Plain PyTorch version of K1.  a, b (B,V,H1) bf16; nbr (B,V,D) int64;
    mask (B,V,D) bool; w2 (H1,H2); vectors fp32.  Returns (B,V,H2) fp32."""
    return _edge_tail(a, _gather(b, nbr), mask, w2, b2, g1, be1, g2, be2)


def _check_windowed_shape(V: int, tile_v: int) -> None:
    if V % tile_v or V // tile_v < 3:
        raise ValueError(f"windowed edge kernel needs V % tile == 0 and V // tile >= 3, "
                         f"got V={V}, tile={tile_v}")


def in_window(nbr: torch.Tensor, tile_v: int) -> torch.Tensor:
    """(B,V,D) -> bool: neighbour inside its vertex tile's window, the 3*tile_v
    rows from clip(i - 1, 0, NB - 3) * tile_v for vertex tile i of NB."""
    V = nbr.shape[1]
    _check_windowed_shape(V, tile_v)
    tile = torch.arange(V, device=nbr.device) // tile_v
    ws = ((tile - 1).clamp(0, V // tile_v - 3) * tile_v)[:, None]
    return (nbr >= ws) & (nbr < ws + 3 * tile_v)


def check_neighbor_locality(nbr: np.ndarray, tile_v: int = 256) -> bool:
    """True iff V % tile_v == 0 and every neighbour of every tile_v-row tile
    lies in the tile's window (the windowed kernel's precondition)."""
    nbr = np.asarray(nbr)
    B, V, D = nbr.shape
    if V % tile_v:
        return False
    nb = V // tile_v
    tiles = nbr.reshape(B, nb, tile_v, D)
    for i in range(nb):
        ws = np.clip(i - 1, 0, nb - 3) * tile_v
        t = tiles[:, i]
        if (t < ws).any() or (t >= ws + 3 * tile_v).any():
            return False
    return True


def edge_mlp_windowed_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, tile_v: int = 128):
    """Plain PyTorch version of K5: K1 with each neighbour read from its
    vertex tile's window (`in_window`); a neighbour outside it reads a zero
    row, as the TPU kernel's one-hot gather finds no hit there.  Where
    `check_neighbor_locality` holds this equals `edge_mlp_plain`."""
    gathered = _gather(b, nbr) * in_window(nbr, tile_v)[..., None]
    return _edge_tail(a, gathered, mask, w2, b2, g1, be1, g2, be2)


def _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """Checks what K1, K5 and K6 take; returns the contiguous launch
    arguments' pointers and the fp32 (B,V,H2) output of the forward."""
    B, V, H1 = a.shape
    D = nbr.shape[-1]
    H2 = w2.shape[1]
    if H1 != H2 or H1 not in WIDTHS:
        raise ValueError(f"edge_mlp kernel takes equal widths in {WIDTHS}, got {H1}->{H2}")
    if D > MAX_DEGREE:
        raise ValueError(f"edge_mlp kernel takes degree <= {MAX_DEGREE}, got {D}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("edge_mlp kernel takes bf16 a and b")
    if b.shape != a.shape or nbr.shape != (B, V, D) or mask.shape != (B, V, D):
        raise ValueError("edge_mlp kernel: shape mismatch")
    if nbr.dtype != torch.int64 or mask.dtype != torch.bool:
        raise TypeError("edge_mlp kernel takes int64 nbr and bool mask")
    vecs = [v.float().contiguous() for v in (b2, g1, be1, g2, be2)]
    args = [a.contiguous(), b.contiguous(), nbr.contiguous(), mask.contiguous(),
            w2.to(torch.bfloat16).contiguous(), *vecs]
    for t in args:
        if t.device != a.device:
            raise ValueError("edge_mlp kernel: all tensors must be on one device")
    out = torch.empty((B, V, H2), dtype=torch.float32, device=a.device)
    return [t.data_ptr() for t in args], out


def fused_edge_mlp(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """K1.  Same arguments and result as `edge_mlp_plain`."""
    if not a.is_cuda:
        return edge_mlp_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    ptrs, out = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, D = nbr.shape
    err = kb.library().edge_mlp_forward(*ptrs, out.data_ptr(), B, V, D, a.shape[2],
                                        w2.shape[1], kb.stream())
    kb.check(err, "edge_mlp_forward")
    fused_edge_mlp.launches += 1
    return out


fused_edge_mlp.launches = 0


def fused_edge_mlp_windowed(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, tile_v: int = 128):
    """K5.  Same arguments and result as `edge_mlp_windowed_plain`."""
    if not a.is_cuda:
        return edge_mlp_windowed_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, tile_v)
    _check_windowed_shape(a.shape[1], tile_v)
    if b.data_ptr() % 16:                   # the window is staged in 16-byte loads
        b = b.clone()
    ptrs, out = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, D = nbr.shape
    err = kb.library().edge_mlp_windowed_forward(*ptrs, out.data_ptr(), B, V, D, a.shape[2],
                                                 w2.shape[1], tile_v, kb.stream())
    kb.check(err, "edge_mlp_windowed_forward")
    fused_edge_mlp_windowed.launches += 1
    return out


fused_edge_mlp_windowed.launches = 0


# ---------------------------------------------------------------------------
# K6: the backward of K1, and the trainable tail
# ---------------------------------------------------------------------------

def edge_mlp_bwd_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout, precise: bool = False):
    """Plain PyTorch version of K6: the gradients of `edge_mlp_plain` given
    dout (B,V,H2), as (da, db_table, dw2, db2, dg1, dbe1, dg2, dbe2), fp32.

    The forward is recomputed with edge_mlp_plain's own operations, so the
    max backward routes dout to the valid edges equal to the max the loss
    saw, split equally between ties (0 where a row has no valid edge).
    Precision as the TPU kernel's `precise=False`: a, b rounded to bf16,
    bf16 operands with fp32 sums for dh = ds W2^T, dW2 = h^T ds and the
    scatter of bf16(dx) into db_table; da and the vector sums in fp32.
    `precise=True` takes a and b as given and runs every product in fp32
    (the TPU kernel's formula check)."""
    mx = torch.float32 if precise else torch.bfloat16

    def rnd(t):
        return t.to(mx).float()

    a, b = rnd(a), rnd(b)
    x = a[:, :, None, :] + _gather(b, nbr)                       # (B,V,D,H1)
    xn1, inv1 = _ln_parts(torch.relu(x))
    h = xn1 * g1 + be1
    s = torch.matmul(rnd(h), rnd(w2)) + b2
    xn2, inv2 = _ln_parts(torch.relu(s))
    y = xn2 * g2 + be2
    best = torch.where(mask[..., None], y, torch.full_like(y, -1e30)).max(dim=2, keepdim=True)
    eq = (mask[..., None] & (y == best.values)).float()
    dout = dout.float()
    dout = torch.where(mask.any(dim=2)[..., None], dout, torch.zeros_like(dout))
    dy = eq * (dout[:, :, None, :] / eq.sum(2, keepdim=True).clamp(min=1.0))
    ds = torch.where(s > 0, _ln_bwd(dy, g2, xn2, inv2), torch.zeros_like(s))
    dh = torch.matmul(rnd(ds), rnd(w2).t())
    dw2 = torch.einsum("bvdi,bvdo->io", rnd(h), rnd(ds))
    dx = torch.where(x > 0, _ln_bwd(dh, g1, xn1, inv1), torch.zeros_like(x))
    db = scatter_rows(nbr, rnd(dx), b.shape[1])
    dims = (0, 1, 2)
    return (dx.sum(2), db, dw2, ds.sum(dims), (dh * xn1).sum(dims), dh.sum(dims),
            (dy * xn2).sum(dims), dy.sum(dims))


def fused_edge_mlp_bwd(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout):
    """K6.  Same arguments (a, b bf16) and result as `edge_mlp_bwd_plain`;
    db_table is summed with fp32 atomics, so its last bits vary between
    runs; the other gradients are deterministic."""
    if not a.is_cuda:
        return edge_mlp_bwd_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout)
    ptrs, _ = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, H1 = a.shape
    D, H2 = nbr.shape[-1], w2.shape[1]
    if dout.shape != (B, V, H2) or dout.dtype != torch.float32 or dout.device != a.device:
        raise ValueError("edge_mlp backward kernel takes an fp32 (B,V,H2) dout on a's device")
    dout = dout.contiguous()
    lib = kb.library()
    grid = ctypes.c_int(0)
    kb.check(lib.edge_mlp_backward_grid(B, V, D, H1, H2, ctypes.byref(grid)),
             "edge_mlp_backward_grid")
    f32 = dict(dtype=torch.float32, device=a.device)
    da, db = torch.empty((B, V, H1), **f32), torch.zeros((B, V, H1), **f32)
    dw2, vec = torch.empty((H1, H2), **f32), torch.empty(2 * H1 + 3 * H2, **f32)
    dw2_part = torch.empty((grid.value, H1, H2), **f32)
    vec_part = torch.empty((grid.value, vec.numel()), **f32)
    outs = [dout, da, db, dw2, vec, dw2_part, vec_part]
    err = lib.edge_mlp_backward(*ptrs, *(t.data_ptr() for t in outs), B, V, D, H1, H2,
                                grid.value, kb.stream())
    kb.check(err, "edge_mlp_backward")
    fused_edge_mlp_bwd.launches += 1
    dg1, dbe1, db2, dg2, dbe2 = torch.split(vec, [H1, H1, H2, H2, H2])
    return da, db, dw2, db2, dg1, dbe1, dg2, dbe2


fused_edge_mlp_bwd.launches = 0


class _TrainableTail(torch.autograd.Function):
    """Forward K1 on bf16(a), bf16(b); backward K6.  The gradients of a and b
    return to the fp32 inputs as through the cast."""

    @staticmethod
    def forward(ctx, a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16, nbr, mask, w2, b2, g1, be1, g2, be2)
        return fused_edge_mlp(a16, b16, nbr, mask, w2, b2, g1, be1, g2, be2)

    @staticmethod
    def backward(ctx, dout):
        a16, b16, nbr, mask, w2, b2, g1, be1, g2, be2 = ctx.saved_tensors
        da, db, dw2, db2, dg1, dbe1, dg2, dbe2 = fused_edge_mlp_bwd(
            a16, b16, nbr, mask, w2, b2, g1, be1, g2, be2, dout.float())
        return da, db, None, None, dw2, db2, dg1, dbe1, dg2, dbe2


def fused_edge_mlp_trainable(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """The edge tail with gradients: a, b (B,V,H1) fp32 (rounded to bf16 for
    K1 inside), the rest as `fused_edge_mlp`; returns (B,V,H2) fp32."""
    return _TrainableTail.apply(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
