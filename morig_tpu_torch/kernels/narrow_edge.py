"""The fp32 training tail of the edge layers narrower than 128 (kernels KN
and KNB) — counterpart of the JAX package's fp32 XLA tail
(morig_tpu/nn/gcu.py EdgeMLP, the path its `_fusable` width rule leaves
these layers on in training).

Per vertex v over its D table edges, all in fp32:

    out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))

and 0 where no edge of v is valid; both LayerNorms with the two-pass
statistics of the package's `_ln` (var = mean((x - mu)^2), eps 1e-6).  The
gradient is the one JAX's autodiff gives that tail: the max's split equally
among tied maxima (jnp.max), and each ReLU's derivative 1/2 at exactly 0
(jnp.maximum(x, 0)).

`narrow_edge_fwd` (KN) and `narrow_edge_bwd` (KNB, which recomputes the
forward with KN's own device code, bit for bit, so that its max routes by
exact equality) launch csrc/narrow_edge.cu for CUDA tensors, KNB's per-edge
db rows summed by the ordered row scatter over the table's masked reverse
table, so every gradient repeats bit for bit; for CPU tensors they run the
plain versions `narrow_edge_plain` and `narrow_edge_bwd_plain`.
`narrow_edge_trainable` is the autograd Function of the training path
(nn/gcu.py `narrow_edge`).  Widths: NARROW_WIDTHS, the widths that take the
narrow route at full width and at the tests' width_scale 0.25; any other
raises on the card.
"""
from __future__ import annotations

import ctypes

import torch

from morig_tpu_torch.kernels import build as kb
from morig_tpu_torch.kernels.edge_fused import LN_EPS, MAX_DEGREE, _bwd_plain_parts, ln_parts
from morig_tpu_torch.kernels.gather_fused import gather_plain, reverse_table, row_scatter_launch
from morig_tpu_torch.kernels.neighbors import masked_max

NARROW_WIDTHS = (8, 16, 32, 64)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), whose autograd derivative at exactly 0 is 1/2, as
    jnp.maximum's is (torch.relu's is 0)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def narrow_edge_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """Plain PyTorch version of KN: a, b (B,V,H) fp32, nbr (B,V,D) int64,
    mask (B,V,D) bool, w2 (H,H), vectors (H,) -> (B,V,H) fp32.
    Differentiable: its autograd gradient is `narrow_edge_bwd_plain`'s."""
    x = a.float()[:, :, None, :] + gather_plain(b.float(), nbr)
    h = ln_parts(_relu(x), True)[0] * g1 + be1
    s = torch.matmul(h, w2.float()) + b2
    y = ln_parts(_relu(s), True)[0] * g2 + be2
    return masked_max(y, mask, dim=2)


def narrow_edge_bwd_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout, rev=None):
    """Plain PyTorch version of KNB: the gradients of `narrow_edge_plain`
    given dout (B,V,H), written out in fp32, as (da, db_table, dw2, db2,
    dg1, dbe1, dg2, dbe2): K6's plain backward (`_bwd_plain_parts`) in fp32
    with the two-pass statistics and each ReLU's derivative 1/2 at 0 — the
    max's gradient to the valid edges equal to it, split equally between
    ties (0 where a vertex has no valid edge).  db_table sums the per-edge
    rows in their flat (b, v, d) order, over `rev` (the table's reverse
    table) where given."""
    return _bwd_plain_parts(a.float(), b.float(), nbr, mask, w2.float(), b2, g1, be1, g2, be2,
                            dout, precise=True, two=True, relu_half=True, rev=rev)[0]


def near_tie_vertices(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, delta: float = 1e-5):
    """(B, V) bool on a's device: the vertices whose gradient route two fp32
    evaluations of the tail in other summation orders (KNB and its plain
    version) could take apart, from the tail in float64: a valid edge whose
    second ReLU input lies within `delta` of 0 (and is not 0: an exact 0,
    from an all-zero row, is 0 on every route), or a channel whose two
    largest distinct values over the valid edges lie within `delta`.  (The
    first ReLU's input a + b is one fp32 sum on every route, and the exact
    ties of duplicated neighbours compute alike.)  For the checks that hold
    KNB to its plain version with those vertices' dout at 0."""
    a, b, w2, b2, g1, be1, g2, be2 = (t.detach().double() for t in (a, b, w2, b2, g1, be1, g2,
                                                                       be2))

    def ln(x, g, be):
        mu = x.mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + LN_EPS) * g + be

    h = ln(torch.relu(a[:, :, None, :] + gather_plain(b, nbr)), g1, be1)
    s = h @ w2 + b2
    low = torch.tensor(float("-inf"), dtype=torch.float64, device=a.device)
    y = torch.where(mask[..., None], ln(torch.relu(s), g2, be2), low)
    top = y.amax(2, keepdim=True)
    second = torch.where(y < top, y, low).amax(2)
    near_relu = (mask[..., None] & (s.abs() <= delta) & (s != 0)).any(-1).any(-1)
    return near_relu | ((top[:, :, 0] - second) <= delta).any(-1)


def _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """Checks what KN and KNB take; returns the launch arguments (a and b
    contiguous and 16-byte aligned, a view that is not copied; W2 fp32
    contiguous; the vectors as one g1 | be1 | b2 | g2 | be2 tensor).  The
    caller holds them until the launch is queued."""
    B, V, H = a.shape
    D = nbr.shape[-1]
    if H not in NARROW_WIDTHS or w2.shape != (H, H):
        raise ValueError(f"narrow edge kernel takes equal widths in {NARROW_WIDTHS}, got "
                         f"{H}->{w2.shape[-1]}")
    if not 1 <= D <= MAX_DEGREE:
        raise ValueError(f"narrow edge kernel takes degree 1..{MAX_DEGREE}, got {D}")
    if any(t.dtype != torch.float32 for t in (a, b, w2, b2, g1, be1, g2, be2)):
        raise TypeError("narrow edge kernel takes fp32 a, b, W2 and vectors")
    if b.shape != a.shape or nbr.shape != (B, V, D) or mask.shape != (B, V, D):
        raise ValueError("narrow edge kernel: shape mismatch")
    if nbr.dtype != torch.int64 or mask.dtype != torch.bool:
        raise TypeError("narrow edge kernel takes int64 nbr and bool mask")
    a, b = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format) for t in (a, b))
    args = [a, b, nbr.contiguous(), mask.contiguous(), w2.contiguous(),
            torch.cat([g1, be1, b2, g2, be2])]
    if any(t.device != a.device for t in args):
        raise ValueError("narrow edge kernel: all tensors must be on one device")
    return args


def narrow_edge_fwd(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """KN.  Same arguments and result as `narrow_edge_plain`."""
    if not a.is_cuda:
        return narrow_edge_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    args = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, H = a.shape
    out = torch.empty((B, V, H), dtype=torch.float32, device=a.device)
    err = kb.library().narrow_edge_forward(*(t.data_ptr() for t in args + [out]), B, V,
                                           nbr.shape[-1], H, kb.stream(a.device))
    kb.check(err, "narrow_edge_forward")
    narrow_edge_fwd.launches += 1
    return out


narrow_edge_fwd.launches = 0


def narrow_edge_bwd(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout, rev=None,
                    return_forward: bool = False):
    """KNB.  Same arguments and result as `narrow_edge_bwd_plain`; `rev`:
    the table's masked reverse table, `reverse_table(nbr, V, mask)` (built
    here when not given; a MeshBatch holds its tables'), over which the
    ordered row scatter sums the per-edge dx rows KNB writes.  Three
    launches (the main kernel, the fixed-order fold of its partials, the
    scatter), counted as one; a call repeats bit for bit.
    `return_forward` (for the tests of the route's invariant): also return
    the forward KNB recomputed, (B,V,H) fp32, which equals
    `narrow_edge_fwd`'s output bit for bit, as (gradients, forward)."""
    if not a.is_cuda:
        grads = narrow_edge_bwd_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout, rev)
        if return_forward:
            return grads, narrow_edge_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
        return grads
    args = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, H = a.shape
    D = nbr.shape[-1]
    if dout.shape != (B, V, H) or dout.dtype != torch.float32 or dout.device != a.device:
        raise ValueError("narrow edge backward kernel takes an fp32 (B,V,H) dout on a's device")
    dout = dout if dout.is_contiguous() and dout.data_ptr() % 16 == 0 else dout.clone(
        memory_format=torch.contiguous_format)
    lib = kb.library()
    grid = ctypes.c_int(0)
    kb.check(lib.narrow_edge_backward_grid(B, V, D, ctypes.byref(grid)),
             "narrow_edge_backward_grid")
    f32 = dict(dtype=torch.float32, device=a.device)
    da, dxe = torch.empty((B, V, H), **f32), torch.empty((B * V * D, H), **f32)
    part = torch.empty((grid.value, H * H + 5 * H), **f32)
    sums = torch.empty(H * H + 5 * H, **f32)
    ymax = torch.empty((B, V, H), **f32) if return_forward else None
    err = lib.narrow_edge_backward(*(t.data_ptr() for t in args + [dout, da, dxe, part, sums]),
                                   None if ymax is None else ymax.data_ptr(), B, V, D, H,
                                   grid.value, kb.stream(a.device))
    kb.check(err, "narrow_edge_backward")
    order, offsets = rev if rev is not None else reverse_table(nbr, V, mask)
    db = row_scatter_launch(dxe, order, offsets, B * V, edge_db=True).reshape(B, V, H)
    narrow_edge_bwd.launches += 1
    dw2, dg1, dbe1, db2, dg2, dbe2 = torch.split(sums, [H * H, H, H, H, H, H])
    grads = da, db, dw2.reshape(H, H), db2, dg1, dbe1, dg2, dbe2
    return (grads, ymax) if return_forward else grads


narrow_edge_bwd.launches = 0


class _NarrowTail(torch.autograd.Function):
    """Forward KN, backward KNB (their plain versions on CPU tensors);
    `order`, `offsets`: the table's masked reverse table, or None."""

    @staticmethod
    def forward(ctx, a, b, nbr, mask, w2, b2, g1, be1, g2, be2, order, offsets):
        ctx.save_for_backward(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, order, offsets)
        return narrow_edge_fwd(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)

    @staticmethod
    def backward(ctx, dout):
        *args, order, offsets = ctx.saved_tensors
        rev = None if order is None else (order, offsets)
        da, db, dw2, db2, dg1, dbe1, dg2, dbe2 = narrow_edge_bwd(*args, dout.float(), rev=rev)
        return da, db, None, None, dw2, db2, dg1, dbe1, dg2, dbe2, None, None


def narrow_edge_trainable(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, rev=None):
    """The narrow tail with gradients: a, b (B,V,H) fp32, the rest as
    `narrow_edge_plain`; returns (B,V,H) fp32.  Forward KN, backward KNB,
    its db_table summed over `rev` (the table's masked reverse table, as a
    MeshBatch holds it; built in the backward when None)."""
    order, offsets = (None, None) if rev is None else rev
    return _NarrowTail.apply(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, order, offsets)
