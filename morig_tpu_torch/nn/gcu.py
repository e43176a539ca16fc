"""Graph convolution units over fixed-width neighbor tables — counterpart of
morig_tpu/nn/gcu.py ("layer" norm mode).

The first edge layer is decomposed per vertex: W [x_i ; x_j - x_i] + b =
(W1 - W2) x_i + W2 x_j + b, so `lin_self` holds (W1 - W2) with the bias and
`lin_nbr` holds W2.  At inference both run as bf16 matmuls (the JAX
package's bf16 edge messages, at every width) and the per-edge tail runs in
kernel K1, or in the windowed kernel K5 when the mesh batch carries an
`edge_tile` (`auto_select_edge_impl`).

In training (`train=True`) both run in fp32 and the route follows the JAX
package's width rule (`jax_kernel_widths`, its `_fusable`): a layer with
H1 >= 128 and H1, H2 multiples of 128 goes through
`fused_edge_mlp_trainable`: K1 forward on bf16(a), bf16(b), or K5 where the
batch carries an `edge_tile`, and K6 backward on the whole table either way
(on tables local at the tile K5 computes K1's function bit for bit, which
K6's max routing needs; K6 sums db_table over the reverse table the batch
holds, `MeshBatch.tpl_rev`): the JAX package's `set_edge_impl("fused")` and
`set_edge_impl("windowed")` training.  Every narrower layer trains on the
JAX package's fp32 XLA tail, `narrow_edge_trainable`, with no bf16 rounding and no
windowing: relu(a + gather(b)), LayerNorm, relu(h W2 + b2), LayerNorm,
masked max, with the tail's two-pass LayerNorm statistics and the gradient
JAX's autodiff gives it (relu'(0) = 1/2), fused into the port's kernel pair
KN forward and KNB backward (kernels/narrow_edge.py; KNB's db_table summed
over the batch's reverse table by the ordered row scatter), so a step
still repeats bit for bit.  JAX's other gates are not
carried: its VMEM budgets model the TPU's scoped memory, and its rule that
V be a multiple of its 256-vertex tile holds for every bucket the port's
datasets pad to (256, 512, 1024, 2048, 4096, 8192: data/pose.py,
data/rig.py, data/creature.py; serving's 1536 too).

A layer whose widths the kernels do not take (`kernel_widths` false: the
narrow layers of a net built with a small `width_scale`) runs K1's plain
version, `plain_edge`, at inference, and `narrow_edge_trainable` in
training.  The choice is made on the widths alone, like the JAX package's
`_fusable`; each call of `plain_edge` is counted in `plain_edge.launches`,
and the narrow route's kernels count their own launches.

In "batch" and "none" norm mode (`nn.mlp.set_default_norm`) an EdgeMLP
has no LayerNorm tail, so no edge kernel computes it: the JAX package's
`_fusable` refuses every mode but "layer" too.  Its tail is plain fp32
PyTorch, as the JAX package's XLA path: gather, relu, `norm_0`, `dense_1`,
relu, `norm_1`, masked max, each `norm_i.bn` a `MaskedBatchNorm` over the
edge tensor masked by the table's validity ("batch"; nothing in "none").
The fuse MLPs of GCU and GCUMotion take the vertex mask.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from morig_tpu_torch.core.batch import MeshBatch
from morig_tpu_torch.kernels.edge_fused import (
    WIDTHS, check_neighbor_locality, edge_mlp_plain, fused_edge_mlp, fused_edge_mlp_trainable,
    fused_edge_mlp_windowed)
from morig_tpu_torch.kernels.gather_fused import gather_plain
from morig_tpu_torch.kernels.narrow_edge import narrow_edge_trainable
from morig_tpu_torch.kernels.neighbors import masked_max
from morig_tpu_torch.nn.mlp import MLP, Dense, get_default_norm, lecun_normal_
from morig_tpu_torch.nn.norm import MaskedBatchNorm


def auto_select_edge_impl(entries: Sequence[dict], tile_v: int = 128) -> str:
    """"windowed" (K5 at `tile_v`) when the padded V is at least 3 tiles of
    tile_v and every table of every entry (dicts with (V, D)
    'tpl_nbr'/'geo_nbr') is local at it (`check_neighbor_locality`):
    ring-ordered meshes, or any mesh after data/preprocess.py's RCM order.
    "fused" (the full-table K1) otherwise; K1 takes any V.  The JAX package's third choice, "xla" above
    V = 2048, and its per-layer VMEM budgets guard the TPU's scoped-VMEM
    limits, which Hopper's kernels do not have.  Pass the choice on with the
    batch: stack_meshes(..., edge_tile=tile_v) for "windowed"."""
    V = max(int(np.asarray(e["tpl_nbr"]).shape[0]) for e in entries)
    local = V % tile_v == 0 and V // tile_v >= 3 and all(
        check_neighbor_locality(np.asarray(e[k])[None], tile_v=tile_v)
        for e in entries for k in ("tpl_nbr", "geo_nbr"))
    return "windowed" if local else "fused"


def windowed_tile(entries: Sequence[dict], tile_v: Optional[int]) -> Optional[int]:
    """The `edge_tile` to stack these mesh entries with: `tile_v` where
    `auto_select_edge_impl(entries, tile_v)` says "windowed", None (the
    full-table K1) where it says "fused" or no tile is asked for.  The
    datasets' `edge_tile` option, the rule `predict_rig_batch` follows."""
    if tile_v and auto_select_edge_impl(entries, tile_v) == "windowed":
        return tile_v
    return None


def kernel_widths(h1: int, h2: int) -> bool:
    """True where the edge kernels (K1, K5, K6) take an edge layer h1 -> h2."""
    return h1 == h2 and h1 in WIDTHS


def plain_edge(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """The edge tail of a layer whose widths the kernels do not take: K1's
    plain version on bf16(a), bf16(b) (the rounding the kernel route
    applies), differentiable by autograd.  Counted in `plain_edge.launches`."""
    plain_edge.launches += 1
    return edge_mlp_plain(a.to(torch.bfloat16), b.to(torch.bfloat16), nbr, mask, w2, b2,
                          g1, be1, g2, be2)


plain_edge.launches = 0


def jax_kernel_widths(h1: int, h2: int) -> bool:
    """True where the JAX package trains an edge layer h1 -> h2 through its
    Pallas kernels (the width rule of its `_fusable`: H1 >= 128, H1 and H2
    multiples of 128); narrower layers train on its fp32 XLA tail."""
    return h1 >= 128 and h1 % 128 == 0 and h2 % 128 == 0


class EdgeNorm(nn.Module):
    """One post-ReLU norm stage of an edge MLP outside "layer" mode: its
    `bn` in "batch" mode, the identity in "none"."""

    def __init__(self, n: int, norm: str):
        super().__init__()
        if norm == "batch":
            self.bn = MaskedBatchNorm(n)

    def forward(self, h, mask, train: bool):
        return self.bn(h, mask, train) if hasattr(self, "bn") else h


class EdgeMLP(nn.Module):
    """Edge message MLP [h1, h2] over [x_i, x_j - x_i] + masked max over the
    table; returns (B,V,h2) fp32.  Its tail is the LayerNorm one of the
    edge kernels in "layer" mode, `norm_0` / `dense_1` / `norm_1` in the
    others (the mode current when it is built)."""

    def __init__(self, fin: int, channels: Sequence[int]):
        super().__init__()
        h1, h2 = channels
        self.norm = get_default_norm()
        self.kernel_route = self.norm == "layer" and kernel_widths(h1, h2)
        # "layer" mode's training route: "kernel" (K1/K5 + K6) at the JAX
        # package's kernel widths where the port's kernels take them,
        # "narrow" (`narrow_edge_trainable`) otherwise
        self.train_route = (None if self.norm != "layer"
                            else "kernel" if self.kernel_route and jax_kernel_widths(h1, h2)
                            else "narrow")
        self.lin_self = Dense(fin, h1)
        self.lin_nbr = Dense(fin, h1, bias=False)
        if self.norm != "layer":
            self.norm_0 = EdgeNorm(h1, self.norm)
            self.dense_1 = Dense(h1, h2)
            self.norm_1 = EdgeNorm(h2, self.norm)
            return
        self.dense_1_kernel = nn.Parameter(torch.empty(h1, h2))   # (in, out)
        self.dense_1_bias = nn.Parameter(torch.empty(h2))
        self.ln0_scale = nn.Parameter(torch.empty(h1))
        self.ln0_bias = nn.Parameter(torch.empty(h1))
        self.ln1_scale = nn.Parameter(torch.empty(h2))
        self.ln1_bias = nn.Parameter(torch.empty(h2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.norm != "layer":
            return
        lecun_normal_(self.dense_1_kernel, self.dense_1_kernel.shape[0], generator)
        self.dense_1_bias.zero_()
        self.ln0_scale.fill_(1.0)
        self.ln0_bias.zero_()
        self.ln1_scale.fill_(1.0)
        self.ln1_bias.zero_()

    def forward(self, x, nbr, nbr_mask, edge_tile: Optional[int] = None, train: bool = False,
                rev=None):
        """"layer" mode: at inference K5 at `edge_tile` when given, K1
        otherwise (`plain_edge` at widths the kernels do not take).  In
        training, on fp32 lin_self/lin_nbr, by `train_route`: "kernel" the
        same forward with K6 backward, "narrow" `narrow_edge_trainable`
        (KN forward, KNB backward; `edge_tile` unused); K6's and KNB's db_table sum over `rev`, the table's
        reverse table, when given.  Other modes: the fp32
        tail in PyTorch (`edge_tile` unused)."""
        if self.norm != "layer":
            a = self.lin_self(x)
            h = torch.relu(a[:, :, None, :] + gather_plain(self.lin_nbr(x), nbr))
            h = self.norm_0(h, nbr_mask, train)
            h = self.norm_1(torch.relu(self.dense_1(h)), nbr_mask, train)
            return masked_max(h, nbr_mask, dim=2).float()
        dt = torch.float32 if train else torch.bfloat16
        a = self.lin_self(x, dt)
        b = self.lin_nbr(x, dt)
        args = (a, b, nbr, nbr_mask, self.dense_1_kernel, self.dense_1_bias,
                self.ln0_scale, self.ln0_bias, self.ln1_scale, self.ln1_bias)
        if train and self.train_route == "narrow":
            return narrow_edge_trainable(*args, rev=rev)
        if not self.kernel_route:
            return plain_edge(*args)
        if train:
            return fused_edge_mlp_trainable(*args, tile_v=edge_tile, rev=rev)
        if edge_tile:
            return fused_edge_mlp_windowed(*args, tile_v=edge_tile)
        return fused_edge_mlp(*args)


def reverse_tables(mesh: MeshBatch, train: bool):
    """The batch's (tpl, geo) reverse tables, which K6 and KNB read in
    training; (None, None) at inference."""
    return (mesh.tpl_rev, mesh.geo_rev) if train else (None, None)


class EdgeConv(nn.Module):
    """DGCNN-style conv: its one EdgeMLP is `nn_pos`."""

    def __init__(self, fin: int, channels: Sequence[int]):
        super().__init__()
        self.nn_pos = EdgeMLP(fin, channels)

    def forward(self, x, nbr, nbr_mask, edge_tile=None, train: bool = False, rev=None):
        return self.nn_pos(x, nbr, nbr_mask, edge_tile, train, rev)


class GCU(nn.Module):
    """Topology + geodesic EdgeConvs, concatenated, then a fuse MLP."""

    def __init__(self, fin: int, out_channels: int):
        super().__init__()
        half = out_channels // 2
        self.edge_conv_tpl = EdgeConv(fin, [half, half])
        self.edge_conv_geo = EdgeConv(fin, [half, half])
        self.mlp = MLP(2 * half, [out_channels])

    def forward(self, x, mesh: MeshBatch, train: bool = False):
        tpl_rev, geo_rev = reverse_tables(mesh, train)
        x_tpl = self.edge_conv_tpl(x, mesh.tpl_nbr, mesh.tpl_mask, mesh.edge_tile, train, tpl_rev)
        x_geo = self.edge_conv_geo(x, mesh.geo_nbr, mesh.geo_mask, mesh.edge_tile, train, geo_rev)
        return self.mlp(torch.cat([x_tpl, x_geo], -1), mesh.vert_mask, train)


class EdgeConvMotion(nn.Module):
    """Separate feature (`nn_x`) and position (`nn_pos`) edge MLPs."""

    def __init__(self, pos_in: int, x_in: int, x_channels, pos_channels):
        super().__init__()
        self.nn_x = EdgeMLP(x_in, x_channels)
        self.nn_pos = EdgeMLP(pos_in, pos_channels)

    def forward(self, pos, x, nbr, nbr_mask, edge_tile=None, train: bool = False, rev=None):
        return torch.cat([self.nn_x(x, nbr, nbr_mask, edge_tile, train, rev),
                          self.nn_pos(pos, nbr, nbr_mask, edge_tile, train, rev)], -1)


class GCUMotion(nn.Module):
    """Motion-conditioned GCU: tpl + geo EdgeConvMotion pair + fuse MLP."""

    def __init__(self, pos_in: int, x_in: int, out_channels: int, dim_pos_feat: int = 16):
        super().__init__()
        half = out_channels // 2
        pc = [dim_pos_feat, dim_pos_feat]
        self.edge_conv_tpl = EdgeConvMotion(pos_in, x_in, [half, half], pc)
        self.edge_conv_geo = EdgeConvMotion(pos_in, x_in, [half, half], pc)
        self.mlp = MLP(2 * (half + dim_pos_feat), [out_channels])

    def forward(self, pos, x, mesh: MeshBatch, train: bool = False):
        tpl_rev, geo_rev = reverse_tables(mesh, train)
        x_tpl = self.edge_conv_tpl(pos, x, mesh.tpl_nbr, mesh.tpl_mask, mesh.edge_tile, train,
                                   tpl_rev)
        x_geo = self.edge_conv_geo(pos, x, mesh.geo_nbr, mesh.geo_mask, mesh.edge_tile, train,
                                   geo_rev)
        return self.mlp(torch.cat([x_tpl, x_geo], -1), mesh.vert_mask, train)
