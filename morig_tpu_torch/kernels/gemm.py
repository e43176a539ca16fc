"""The row-invariant fp32 matrix product (kernel KG, a kernel of the port's
own) and the products of a training step that go through it.

`gemm(a, b, bias)` computes a @ b (+ bias) in fp32 with every output
element summing its K products in one fixed order (csrc/gemm_f32.cu), so a
row's bits do not depend on how many rows, columns or batch entries share
the call: a rank of a data-parallel step computes its rows as the
one-device step on the whole batch does, and a tensor-parallel layer's
columns as the whole layer's.  On a CPU tensor it is `gemm_plain`
(`torch.matmul`), the port's CPU numerics.

`linear` (nn.mlp.Dense's fp32 x @ W^T + b, and the local product of
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

from typing import Optional

import torch

from morig_tpu_torch.kernels import build as kb


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


def gemm(a, b, bias=None):
    """KG.  a (batch, M, K) or (M, K), b (batch, K, N) or (K, N), both fp32
    (any strides; a matrix with neither axis contiguous is copied), bias
    (N) or None -> (batch, M, N) or (M, N) fp32, contiguous."""
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
    a, sab, sam, sak = _operand(a, batch)
    b, sbb, sbk, sbn = _operand(b, batch)
    bias = bias.contiguous() if bias is not None else None
    err = kb.library().gemm_f32(a.data_ptr(), sab, sam, sak, b.data_ptr(), sbb, sbk, sbn,
                                bias.data_ptr() if bias is not None else None, out.data_ptr(),
                                batch, M, N, K, kb.stream(dev))
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
