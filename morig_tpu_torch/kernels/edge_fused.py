"""Fused EdgeMLP tail (kernels K1 and K5) — counterpart of
morig_tpu/kernels/edge_fused.py.

Per vertex v over its D table edges:

    out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))

and 0 where no edge of v is valid.  a and b arrive rounded to bf16; the W2
product takes bf16 operands with fp32 accumulation; both LayerNorms run in
fp32 (eps 1e-6, variance E[x^2] - E[x]^2) over the true width.

K1 (`fused_edge_mlp`) reads each neighbour row from the whole table; K5
(`fused_edge_mlp_windowed`) reads it from its vertex tile's window of
3 tiles, for meshes whose neighbours are local (`check_neighbor_locality`).
Each launches its CUDA kernel (csrc/edge_mlp.cu) for a CUDA tensor and runs
its plain version (`edge_mlp_plain`, `edge_mlp_windowed_plain`) for a CPU
tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from morig_tpu_torch.kernels import build as kb

LN_EPS = 1e-6
MAX_DEGREE = 16
WIDTHS = (16, 32, 64, 128, 256)


def layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis with flax's statistics: var =
    max(E[x^2] - E[x]^2, 0), eps 1e-6."""
    h = h.float()
    mu = h.mean(-1, keepdim=True)
    var = torch.clamp((h * h).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (h - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


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
    """Checks what K1 and K5 take; returns the contiguous launch arguments
    and the fp32 output."""
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
    return [t.data_ptr() for t in args] + [out.data_ptr()], out


def fused_edge_mlp(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """K1.  Same arguments and result as `edge_mlp_plain`."""
    if not a.is_cuda:
        return edge_mlp_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    ptrs, out = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, D = nbr.shape
    err = kb.library().edge_mlp_forward(*ptrs, B, V, D, a.shape[2], w2.shape[1], kb.stream())
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
    err = kb.library().edge_mlp_windowed_forward(*ptrs, B, V, D, a.shape[2], w2.shape[1],
                                                 tile_v, kb.stream())
    kb.check(err, "edge_mlp_windowed_forward")
    fused_edge_mlp_windowed.launches += 1
    return out


fused_edge_mlp_windowed.launches = 0
