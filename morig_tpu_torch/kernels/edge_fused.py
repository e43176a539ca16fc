"""Fused EdgeMLP tail (kernels K1 and K5) and its backward (kernel K6) —
counterpart of morig_tpu/kernels/edge_fused.py.

Per vertex v over its D table edges:

    out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))

and 0 where no edge of v is valid.  a and b arrive rounded to bf16; the W2
product takes bf16 operands with fp32 accumulation; both LayerNorms run in
fp32 (eps 1e-6, variance E[x^2] - E[x]^2) over the true width.

K1 (`fused_edge_mlp`, the serving call and the training forward) reads each
neighbour row from the whole table; K5 (`fused_edge_mlp_windowed`) reads it
from its vertex tile's window of 3 tiles, for meshes whose neighbours are
local (`check_neighbor_locality`).  Both run the wgmma step code
(csrc/edge_wgmma.cuh).  K6 (`fused_edge_mlp_bwd`) is the one-pass backward
with an in-kernel recompute of the forward on K1's own step code, bit for
bit, so that its max routes by exact equality (dW2 in a kernel of its own
over scratch tiles the main kernel writes; `fused_edge_mlp_dw2` runs it
alone), and `fused_edge_mlp_trainable` the autograd Function of the
training path: forward K1, backward K6.  Each launches its CUDA kernel
(csrc/edge_mlp.cu, csrc/edge_mlp_bwd.cu) for a CUDA tensor and runs its
plain version (`edge_mlp_plain`, `edge_mlp_windowed_plain`,
`edge_mlp_bwd_plain`) for a CPU tensor.
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


def _tail_plain(a, gathered, mask, w2, b2, g1, be1, g2, be2):
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
    return _tail_plain(a, _gather(b, nbr), mask, w2, b2, g1, be1, g2, be2)


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
    return _tail_plain(a, gathered, mask, w2, b2, g1, be1, g2, be2)


def _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """Checks what K1, K5 and K6 take; returns the launch arguments — W2 in
    `wgmma_w2_layout`, a and b contiguous and 16-byte aligned (the kernels
    read them in 16-byte pieces and bulk copies; a view that is not gets
    copied) — and the fp32 (B,V,H2) output of the forward.  The caller
    holds the arguments until the launch is queued: a copy made here and
    freed before then could be handed to a buffer allocated in between."""
    B, V, H1 = a.shape
    D = nbr.shape[-1]
    H2 = w2.shape[1]
    if H1 != H2 or H1 not in WIDTHS:
        raise ValueError(f"edge_mlp kernel takes equal widths in {WIDTHS}, got {H1}->{H2}")
    if D > MAX_DEGREE:
        raise ValueError(f"edge_mlp kernel takes degree <= {MAX_DEGREE}, got {D}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("edge_mlp kernel takes bf16 a and b")
    if (b.shape != a.shape or w2.shape != (H1, H2) or nbr.shape != (B, V, D)
            or mask.shape != (B, V, D)):
        raise ValueError("edge_mlp kernel: shape mismatch")
    if nbr.dtype != torch.int64 or mask.dtype != torch.bool:
        raise TypeError("edge_mlp kernel takes int64 nbr and bool mask")
    a, b = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format) for t in (a, b))
    vecs = [v.float().contiguous() for v in (b2, g1, be1, g2, be2)]
    args = [a, b, nbr.contiguous(), mask.contiguous(), wgmma_w2_layout(w2), *vecs]
    for t in args:
        if t.device != a.device:
            raise ValueError("edge_mlp kernel: all tensors must be on one device")
    out = torch.empty((B, V, H2), dtype=torch.float32, device=a.device)
    return args, out


def wgmma_k_order(h: int) -> np.ndarray:
    """K1's, K5's and K6's k order (csrc/edge_wgmma.cuh): entry k is the W2 row (LN1
    column) at the product's physical k.  Lane q of a quad holds LN1 columns
    in pieces of P = 8 (4 at h=16), piece p being columns (4p + q) P ..
    (4p + q) P + P - 1, which fill k-chunks p P/4 ..; wgmma takes k = 16c +
    2q + {0, 1, 8, 9} of k-chunk c from that lane, so column (4 (c // (P/4))
    + q) P + 4 (c % (P/4)) + j sits at k = 16c + 2q + (j % 2) + 8 (j // 2)."""
    k = np.arange(h)
    c, p16 = k // 16, k % 16
    q, j = (p16 % 8) // 2, p16 % 2 + 2 * (p16 // 8)
    P = min(h // 4, 8)
    per = P // 4
    return (4 * (c // per) + q) * P + 4 * (c % per) + j


_W2_INDEX: dict = {}


def wgmma_w2_layout(w2: torch.Tensor) -> torch.Tensor:
    """W2 (H1, H2) as K1, K5 and K6 stage it in shared memory: bf16, rows in
    `wgmma_k_order`, in wgmma's interleaved K-major layout — core matrices
    of 8 output columns x 8 k, 128 contiguous bytes each (k fastest), H2/8
    of them per group of 8 k, the groups in k order.  One gather and one
    cast on the device."""
    H1, H2 = w2.shape
    key = (H1, H2, w2.device)
    if key not in _W2_INDEX:
        rows = wgmma_k_order(H1).reshape(H1 // 8, 1, 1, 8)          # (kg, -, -, kin)
        cols = np.arange(H2).reshape(1, H2 // 8, 8, 1)              # (-, ng, nin, -)
        _W2_INDEX[key] = torch.as_tensor((rows * H2 + cols).reshape(-1), device=w2.device)
    return w2.reshape(-1)[_W2_INDEX[key]].to(torch.bfloat16)


def fused_edge_mlp(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """K1.  Same arguments and result as `edge_mlp_plain`."""
    if not a.is_cuda:
        return edge_mlp_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    args, out = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, D = nbr.shape
    err = kb.library().edge_mlp_table_forward(*(t.data_ptr() for t in args + [out]), B, V, D,
                                              a.shape[2], w2.shape[1], kb.stream(a.device))
    kb.check(err, "edge_mlp_table_forward")
    fused_edge_mlp.launches += 1
    return out


fused_edge_mlp.launches = 0


def fused_edge_mlp_windowed(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, tile_v: int = 128):
    """K5.  Same arguments and result as `edge_mlp_windowed_plain`."""
    if not a.is_cuda:
        return edge_mlp_windowed_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, tile_v)
    _check_windowed_shape(a.shape[1], tile_v)
    if tile_v % 8:
        raise ValueError(f"windowed edge kernel needs tile % 8 == 0, got {tile_v}")
    args, out = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, D = nbr.shape
    err = kb.library().edge_mlp_windowed_forward(*(t.data_ptr() for t in args + [out]), B, V, D,
                                                 a.shape[2], w2.shape[1], tile_v,
                                                 kb.stream(a.device))
    kb.check(err, "edge_mlp_windowed_forward")
    fused_edge_mlp_windowed.launches += 1
    return out


fused_edge_mlp_windowed.launches = 0


# ---------------------------------------------------------------------------
# K6: the backward of K1, and the trainable tail
# ---------------------------------------------------------------------------

def _bwd_plain_parts(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout, precise: bool = False):
    """`edge_mlp_bwd_plain`'s gradients and its per-edge h and ds (B,V,D,H),
    rounded as the products take them."""
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
    grads = (dx.sum(2), db, dw2, ds.sum(dims), (dh * xn1).sum(dims), dh.sum(dims),
             (dy * xn2).sum(dims), dy.sum(dims))
    return grads, rnd(h), rnd(ds)


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
    return _bwd_plain_parts(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout, precise)[0]


# K6's dW2 runs in its own kernel (csrc/edge_mlp_bwd.cu `edge_mlp_dw2_kernel`)
# over a scratch tile per 64-edge-row step that the main kernel writes: the
# step's h and ds (64 x H bf16 each, zero rows for masked edges and past the
# step's vertices), each in wgmma's no-swizzle K-major core-matrix layout.

STEP_ROWS = 64


def dw2_scratch_index(h: int) -> torch.Tensor:
    """(64, h) int64: where (row r, column c) of a step's h or ds lies in its
    64*h-element part of the scratch tile.  16-byte chunk (g, c), at element
    8 (g h + c), holds rows 8g .. 8g + 7 of column c, so the chunks of
    columns 8n .. 8n + 7 of row group g are one 128-byte core matrix: the
    K-major layout of h^T (M = columns, K = rows) and of ds (K = rows, N =
    columns) that the dW2 kernel reads by ldmatrix and by descriptor."""
    r = torch.arange(STEP_ROWS)[:, None]
    c = torch.arange(h)[None, :]
    return ((r // 8) * h + c) * 8 + r % 8


def dh_operand_index(h: int) -> torch.Tensor:
    """(64, h) int64: where (row r, column c) of a step's ds lies in K6's
    shared-memory B operand of dh^T = W2 ds^T (K = columns, N = rows,
    K-major; csrc/edge_mlp_bwd.cu `dsb_index`): core matrix (c // 8, r // 8)
    at element 64 (8 (c // 8) + r // 8), its row r % 8 holding columns
    8 (c // 8) .. + 7."""
    r = torch.arange(STEP_ROWS)[:, None]
    c = torch.arange(h)[None, :]
    return ((c // 8) * 8 + r // 8) * 64 + (r % 8) * 8 + c % 8


def step_rows(x: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge rows x (B,V,D,H) as K6's steps see them: (n_steps, 64, H)
    with step t = (batch row t // S, vertices (t % S) * (64 // D) ..) for S
    steps per batch row, row vl * D + d the edge d of its vertex vl, zero
    rows for masked edges and past the step's vertices; and live (n_steps,)
    bool, whether the step has a valid edge."""
    B, V, D, H = x.shape
    vpt = STEP_ROWS // D
    S = -(-V // vpt)
    pad = S * vpt - V
    xm = torch.nn.functional.pad(x * mask[..., None], (0, 0, 0, 0, 0, pad))
    mm = torch.nn.functional.pad(mask, (0, 0, 0, pad))
    rows = xm.reshape(B * S, vpt * D, H)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, STEP_ROWS - vpt * D))
    return rows, mm.reshape(B * S, vpt * D).any(dim=1)


def pack_dw2_scratch(h: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Scratch tiles (n_steps, 128 H) bf16 from the steps' h and ds
    (n_steps, 64, H): the h part, then the ds part, each in
    `dw2_scratch_index` order."""
    n, _, H = h.shape
    idx = dw2_scratch_index(H).to(h.device).reshape(-1)
    out = torch.empty((n, 2, STEP_ROWS * H), dtype=torch.bfloat16, device=h.device)
    out[:, 0, idx] = h.reshape(n, -1).to(torch.bfloat16)
    out[:, 1, idx] = ds.reshape(n, -1).to(torch.bfloat16)
    return out.reshape(n, -1)


def bwd_step_tiles(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout):
    """The scratch tiles and live flags K6's main kernel writes for these
    inputs (`edge_mlp_bwd_plain`'s arguments), from the plain backward's own
    h and ds: (tiles (n_steps, 128 H) bf16, live (n_steps,) bool)."""
    _, h, ds = _bwd_plain_parts(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout)
    (h_steps, live), (ds_steps, _) = step_rows(h, mask), step_rows(ds, mask)
    return pack_dw2_scratch(h_steps, ds_steps), live


def edge_mlp_dw2_plain(scratch: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6's dW2 kernel: the sum over the live steps
    of h^T ds from scratch tiles (n_steps, 128 H) bf16 (`pack_dw2_scratch`),
    fp32 (H, H); the tiles of dead steps are not read."""
    H = scratch.shape[1] // (2 * STEP_ROWS)
    idx = dw2_scratch_index(H).to(scratch.device).reshape(-1)
    tiles = scratch[live].reshape(-1, 2, STEP_ROWS * H)[:, :, idx].float()
    tiles = tiles.reshape(-1, 2, STEP_ROWS, H)
    return torch.einsum("tri,tro->io", tiles[:, 0], tiles[:, 1])


def _dw2_splits(lib, H: int) -> int:
    splits = ctypes.c_int(0)
    kb.check(lib.edge_mlp_dw2_grid(H, ctypes.byref(splits)), "edge_mlp_dw2_grid")
    return splits.value


def fused_edge_mlp_dw2(scratch: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """K6's dW2 kernel on its own (the backward launches it itself).  Same
    arguments and result as `edge_mlp_dw2_plain`; live is bool.
    Deterministic for a given grid."""
    if not scratch.is_cuda:
        return edge_mlp_dw2_plain(scratch, live)
    n = scratch.shape[0]
    H = scratch.shape[1] // (2 * STEP_ROWS)
    if (scratch.dtype != torch.bfloat16 or H not in WIDTHS or scratch.shape[1] != 2 * STEP_ROWS * H
            or live.shape != (n,) or live.dtype != torch.bool or live.device != scratch.device):
        raise ValueError("edge_mlp dW2 kernel takes bf16 (n, 128 H) tiles and a bool (n,) live")
    scratch = scratch.contiguous()
    lib = kb.library()
    splits = _dw2_splits(lib, H)
    part = torch.empty((splits, H, H), dtype=torch.float32, device=scratch.device)
    dw2 = torch.empty((H, H), dtype=torch.float32, device=scratch.device)
    flags = live.to(torch.uint8)
    err = lib.edge_mlp_dw2(scratch.data_ptr(), flags.data_ptr(), part.data_ptr(), dw2.data_ptr(),
                           n, H, splits, kb.stream(scratch.device))
    kb.check(err, "edge_mlp_dw2")
    fused_edge_mlp_dw2.launches += 1
    return dw2


fused_edge_mlp_dw2.launches = 0


def fused_edge_mlp_bwd(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout,
                       return_forward: bool = False):
    """K6.  Same arguments (a, b bf16) and result as `edge_mlp_bwd_plain`;
    db_table is summed with fp32 atomics, so its last bits vary between
    runs; the other gradients are deterministic.  Four launches (the main
    kernel, the dW2 kernel over its scratch tiles and two fixed-order sums),
    counted as one.  `return_forward` (for the tests of the route's
    invariant): also return the forward K6 recomputed, (B,V,H2) fp32 —
    the per-vertex max its route compares against, which equals
    `fused_edge_mlp`'s output bit for bit — as (gradients, forward)."""
    if not a.is_cuda:
        grads = edge_mlp_bwd_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout)
        if return_forward:
            return grads, edge_mlp_plain(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
        return grads
    args, ymax = _kernel_args(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
    B, V, H1 = a.shape
    D, H2 = nbr.shape[-1], w2.shape[1]
    if dout.shape != (B, V, H2) or dout.dtype != torch.float32 or dout.device != a.device:
        raise ValueError("edge_mlp backward kernel takes an fp32 (B,V,H2) dout on a's device")
    dout = dout.contiguous()
    b2v, g1v, be1v, g2v, be2v = args[5:]
    vecs = torch.cat([g1v, be1v, b2v, g2v, be2v])
    lib = kb.library()
    grid, splits = ctypes.c_int(0), ctypes.c_int(0)
    kb.check(lib.edge_mlp_backward_grid(B, V, D, H1, H2, ctypes.byref(grid), ctypes.byref(splits)),
             "edge_mlp_backward_grid")
    vpt = STEP_ROWS // D
    n_steps = B * -(-V // vpt)
    f32 = dict(dtype=torch.float32, device=a.device)
    da, db = torch.empty((B, V, H1), **f32), torch.zeros((B, V, H1), **f32)
    dw2, vec = torch.empty((H1, H2), **f32), torch.empty(2 * H1 + 3 * H2, **f32)
    scratch = torch.empty((n_steps, 2 * STEP_ROWS * H1), dtype=torch.bfloat16, device=a.device)
    live = torch.empty(n_steps, dtype=torch.uint8, device=a.device)
    dw2_part = torch.empty((splits.value, H1, H2), **f32)
    vec_part = torch.empty((grid.value, vec.numel()), **f32)
    ptrs = [t.data_ptr() for t in args[:5] + [vecs, dout, da, db, dw2, vec, scratch, live,
                                              dw2_part, vec_part]]
    err = lib.edge_mlp_backward(*ptrs, ymax.data_ptr() if return_forward else None, B, V, D, H1,
                                H2, grid.value, splits.value, kb.stream(a.device))
    kb.check(err, "edge_mlp_backward")
    fused_edge_mlp_bwd.launches += 1
    dg1, dbe1, db2, dg2, dbe2 = torch.split(vec, [H1, H1, H2, H2, H2])
    grads = da, db, dw2, db2, dg1, dbe1, dg2, dbe2
    return (grads, ymax) if return_forward else grads


fused_edge_mlp_bwd.launches = 0


class _TrainableTail(torch.autograd.Function):
    """Forward K1 on bf16(a), bf16(b); backward K6, whose recompute repeats
    K1's bits.  The gradients of a and b return to the fp32 inputs as
    through the cast."""

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
    the forward inside), the rest as `fused_edge_mlp`; returns (B,V,H2) fp32."""
    return _TrainableTail.apply(a, b, nbr, mask, w2, b2, g1, be1, g2, be2)
