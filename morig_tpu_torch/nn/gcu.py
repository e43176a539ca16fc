"""Graph convolution units over fixed-width neighbor tables — counterpart of
morig_tpu/nn/gcu.py ("layer" norm mode).

The first edge layer is decomposed per vertex: W [x_i ; x_j - x_i] + b =
(W1 - W2) x_i + W2 x_j + b, so `lin_self` holds (W1 - W2) with the bias and
`lin_nbr` holds W2.  At inference both run as bf16 matmuls (the JAX
package's bf16 edge messages) and the per-edge tail runs in kernel K1, or in
the windowed kernel K5 when the mesh batch carries an `edge_tile`
(`auto_select_edge_impl`).  In training (`train=True`) both run in fp32 and
the tail goes through `fused_edge_mlp_trainable`: K1 forward on bf16(a),
bf16(b), K6 backward, at every width K1 takes.  The JAX package trains
only 128-multiple widths through its kernels (its TPU lane tiling) and
narrower ones in XLA; here all widths train through K1 + K6, and the full
table is used even where the batch carries an `edge_tile` (K5 has no
backward; on local tables K5 and K1 compute the same function).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from morig_tpu_torch.core.batch import MeshBatch
from morig_tpu_torch.kernels.edge_fused import (
    check_neighbor_locality, fused_edge_mlp, fused_edge_mlp_trainable, fused_edge_mlp_windowed)
from morig_tpu_torch.nn.mlp import MLP, Dense, lecun_normal_


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


class EdgeMLP(nn.Module):
    """Edge message MLP [h1, h2] over [x_i, x_j - x_i] + masked max over the
    table; returns (B,V,h2) fp32."""

    def __init__(self, fin: int, channels: Sequence[int]):
        super().__init__()
        h1, h2 = channels
        self.lin_self = Dense(fin, h1)
        self.lin_nbr = Dense(fin, h1, bias=False)
        self.dense_1_kernel = nn.Parameter(torch.empty(h1, h2))   # (in, out)
        self.dense_1_bias = nn.Parameter(torch.empty(h2))
        self.ln0_scale = nn.Parameter(torch.empty(h1))
        self.ln0_bias = nn.Parameter(torch.empty(h1))
        self.ln1_scale = nn.Parameter(torch.empty(h2))
        self.ln1_bias = nn.Parameter(torch.empty(h2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.dense_1_kernel, self.dense_1_kernel.shape[0], generator)
        self.dense_1_bias.zero_()
        self.ln0_scale.fill_(1.0)
        self.ln0_bias.zero_()
        self.ln1_scale.fill_(1.0)
        self.ln1_bias.zero_()

    def forward(self, x, nbr, nbr_mask, edge_tile: Optional[int] = None, train: bool = False):
        """Training: K1 forward and K6 backward on fp32 lin_self/lin_nbr.
        Inference: K5 at `edge_tile` when given, K1 otherwise."""
        dt = torch.float32 if train else torch.bfloat16
        a = self.lin_self(x, dt)
        b = self.lin_nbr(x, dt)
        args = (a, b, nbr, nbr_mask, self.dense_1_kernel, self.dense_1_bias,
                self.ln0_scale, self.ln0_bias, self.ln1_scale, self.ln1_bias)
        if train:
            return fused_edge_mlp_trainable(*args)
        if edge_tile:
            return fused_edge_mlp_windowed(*args, tile_v=edge_tile)
        return fused_edge_mlp(*args)


class EdgeConv(nn.Module):
    """DGCNN-style conv: its one EdgeMLP is `nn_pos`."""

    def __init__(self, fin: int, channels: Sequence[int]):
        super().__init__()
        self.nn_pos = EdgeMLP(fin, channels)

    def forward(self, x, nbr, nbr_mask, edge_tile=None, train: bool = False):
        return self.nn_pos(x, nbr, nbr_mask, edge_tile, train)


class GCU(nn.Module):
    """Topology + geodesic EdgeConvs, concatenated, then a fuse MLP."""

    def __init__(self, fin: int, out_channels: int):
        super().__init__()
        half = out_channels // 2
        self.edge_conv_tpl = EdgeConv(fin, [half, half])
        self.edge_conv_geo = EdgeConv(fin, [half, half])
        self.mlp = MLP(2 * half, [out_channels])

    def forward(self, x, mesh: MeshBatch, train: bool = False):
        x_tpl = self.edge_conv_tpl(x, mesh.tpl_nbr, mesh.tpl_mask, mesh.edge_tile, train)
        x_geo = self.edge_conv_geo(x, mesh.geo_nbr, mesh.geo_mask, mesh.edge_tile, train)
        return self.mlp(torch.cat([x_tpl, x_geo], -1), train)


class EdgeConvMotion(nn.Module):
    """Separate feature (`nn_x`) and position (`nn_pos`) edge MLPs."""

    def __init__(self, pos_in: int, x_in: int, x_channels, pos_channels):
        super().__init__()
        self.nn_x = EdgeMLP(x_in, x_channels)
        self.nn_pos = EdgeMLP(pos_in, pos_channels)

    def forward(self, pos, x, nbr, nbr_mask, edge_tile=None):
        return torch.cat([self.nn_x(x, nbr, nbr_mask, edge_tile),
                          self.nn_pos(pos, nbr, nbr_mask, edge_tile)], -1)


class GCUMotion(nn.Module):
    """Motion-conditioned GCU: tpl + geo EdgeConvMotion pair + fuse MLP."""

    def __init__(self, pos_in: int, x_in: int, out_channels: int, dim_pos_feat: int = 16):
        super().__init__()
        half = out_channels // 2
        pc = [dim_pos_feat, dim_pos_feat]
        self.edge_conv_tpl = EdgeConvMotion(pos_in, x_in, [half, half], pc)
        self.edge_conv_geo = EdgeConvMotion(pos_in, x_in, [half, half], pc)
        self.mlp = MLP(2 * (half + dim_pos_feat), [out_channels])

    def forward(self, pos, x, mesh: MeshBatch):
        x_tpl = self.edge_conv_tpl(pos, x, mesh.tpl_nbr, mesh.tpl_mask, mesh.edge_tile)
        x_geo = self.edge_conv_geo(pos, x, mesh.geo_nbr, mesh.geo_mask, mesh.edge_tile)
        return self.mlp(torch.cat([x_tpl, x_geo], -1))
