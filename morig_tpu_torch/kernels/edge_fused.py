"""Fused EdgeMLP tail (kernel K1) — counterpart of morig_tpu/kernels/edge_fused.py.

Per vertex v over its D table edges:

    out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))

and 0 where no edge of v is valid.  a and b arrive rounded to bf16; the W2
product takes bf16 operands with fp32 accumulation; both LayerNorms run in
fp32 (eps 1e-6, variance E[x^2] - E[x]^2) over the true width.

`fused_edge_mlp` launches the CUDA kernel (csrc/edge_mlp.cu) for a CUDA
tensor and runs `edge_mlp_plain` for a CPU tensor.
"""
from __future__ import annotations

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


def edge_mlp_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """Plain PyTorch version of K1.  a, b (B,V,H1) bf16; nbr (B,V,D) int64;
    mask (B,V,D) bool; w2 (H1,H2); vectors fp32.  Returns (B,V,H2) fp32."""
    a = a.float()
    bsel = torch.arange(b.shape[0], device=b.device)[:, None, None]
    gathered = b.float()[bsel, nbr]                            # (B,V,D,H1)
    h = torch.relu(a[:, :, None, :] + gathered)
    h = layer_norm(h, g1, be1)
    h2 = torch.matmul(h.to(torch.bfloat16).float(), w2.to(torch.bfloat16).float()) + b2
    h2 = layer_norm(torch.relu(h2), g2, be2)
    h2 = torch.where(mask[..., None], h2, torch.full_like(h2, -1e30))
    out = h2.max(dim=2).values
    return torch.where(mask.any(dim=2)[..., None], out, torch.zeros_like(out))


def fused_edge_mlp(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """K1.  Same arguments and result as `edge_mlp_plain`."""
    if not a.is_cuda:
        return edge_mlp_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
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
    lib = kb.library()
    err = lib.edge_mlp_forward(*(t.data_ptr() for t in args), out.data_ptr(),
                               B, V, D, H1, H2, kb.stream())
    kb.check(err, "edge_mlp_forward")
    fused_edge_mlp.launches += 1
    return out


fused_edge_mlp.launches = 0
