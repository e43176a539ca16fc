"""PointNet++ set abstraction / feature propagation — counterpart of
morig_tpu/nn/pointnet.py (SAModule, GlobalSAModule, FPModule, and
SAModuleMSG, which no network of the reference uses).

FPS starts where the caller says (index 0, the eval start, by default);
radius grouping keeps the exact nearest neighbors.  At inference the row
gathers run in kernel K3; in training they are plain, differentiable
indexed gathers, as the JAX package keeps its gather kernel for inference.
Each MLP takes the mask of its rows (the batch statistics of "batch" norm
mode): the valid neighbours of valid centroids, the valid points.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from morig_tpu_torch.kernels import neighbors as nbk
from morig_tpu_torch.kernels.gather_fused import gather_plain, gather_rows
from morig_tpu_torch.nn.mlp import MLP


def _gather(train: bool):
    return gather_plain if train else gather_rows


def _sample(pos, mask, num_out: int, start):
    """FPS centroids: (new_pos (B,K,3), new_mask (B,K))."""
    idx = nbk.fps(pos, num_out, mask, start)
    return torch.gather(pos, 1, idx[..., None].expand(-1, -1, 3)), torch.gather(mask, 1, idx)


def _group(x, pos, mask, new_pos, new_mask, radius: float, max_neighbors: int, train: bool):
    """Each centroid's neighbours within `radius`: PointConv's input
    [x_j, pos_j - pos_i] (B,K,M,C+3) and its valid entries (B,K,M)."""
    gather = _gather(train)
    grp_idx, grp_valid = nbk.radius_group(new_pos, pos, radius, max_neighbors, mask)
    if x is None:
        feat_in = gather(pos, grp_idx) - new_pos[:, :, None, :]
    else:
        g = gather(torch.cat([x, pos], -1), grp_idx)
        C = x.shape[-1]
        feat_in = torch.cat([g[..., :C], g[..., C:] - new_pos[:, :, None, :]], -1)
    return feat_in, grp_valid & new_mask[:, :, None]


class SAModule(nn.Module):
    """FPS downsample to `num_out` centroids + radius neighborhood + PointConv
    MLP([x_j, pos_j - pos_i]) with max aggregation.  `fin` is the width of x
    (0 when x is None); `num_out` follows the input size, so it is a call
    argument."""

    def __init__(self, fin: int, radius: float, mlp_channels: Sequence[int],
                 max_neighbors: int = 64):
        super().__init__()
        self.radius = radius
        self.max_neighbors = max_neighbors
        self.conv = MLP(fin + 3, mlp_channels)

    def forward(self, x, pos, mask, num_out: int, train: bool = False, start=None):
        new_pos, new_mask = _sample(pos, mask, num_out, start)
        feat_in, valid = _group(x, pos, mask, new_pos, new_mask, self.radius,
                                self.max_neighbors, train)
        new_x = nbk.masked_max(self.conv(feat_in, valid, train), valid, dim=2)
        return new_x, new_pos, new_mask


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction: one FPS downsample to `num_out`
    centroids shared by several (radius, MLP, max_neighbors) scales, each
    scale's PointConv max (`conv_{s}`) concatenated.  Arguments as
    SAModule's, one entry per scale."""

    def __init__(self, fin: int, radii: Sequence[float], mlp_channels_list,
                 max_neighbors_list: Sequence[int]):
        super().__init__()
        self.radii = list(radii)
        self.max_neighbors_list = list(max_neighbors_list)
        for s, chans in enumerate(mlp_channels_list):
            self.add_module(f"conv_{s}", MLP(fin + 3, chans))

    def forward(self, x, pos, mask, num_out: int, train: bool = False, start=None):
        new_pos, new_mask = _sample(pos, mask, num_out, start)
        feats = []
        for s, (r, max_nn) in enumerate(zip(self.radii, self.max_neighbors_list)):
            feat_in, valid = _group(x, pos, mask, new_pos, new_mask, r, max_nn, train)
            conv = getattr(self, f"conv_{s}")
            feats.append(nbk.masked_max(conv(feat_in, valid, train), valid, dim=2))
        return torch.cat(feats, -1), new_pos, new_mask


class GlobalSAModule(nn.Module):
    """Global max-pool abstraction over MLP([x, pos])."""

    def __init__(self, fin: int, mlp_channels: Sequence[int]):
        super().__init__()
        self.nn = MLP(fin + 3, mlp_channels)

    def forward(self, x, pos, mask, train: bool = False):
        return nbk.masked_max(self.nn(torch.cat([x, pos], -1), mask, train), mask, dim=1)


class FPModule(nn.Module):
    """Feature propagation: inverse-distance kNN interpolation (or broadcast of
    a global feature) + skip concat + MLP."""

    def __init__(self, k: int, fin: int, fin_skip: int, mlp_channels: Sequence[int]):
        super().__init__()
        self.k = k
        self.nn = MLP(fin + fin_skip, mlp_channels)

    def forward(self, x, pos, mask, x_skip, pos_skip, mask_skip, train: bool = False):
        if x.dim() == 2:
            up = x[:, None, :].expand(-1, pos_skip.shape[1], -1)
        else:
            up = nbk.knn_interpolate(x, pos, pos_skip, self.k, mask, train=train)
        if x_skip is not None:
            up = torch.cat([up, x_skip], -1)
        return self.nn(up, mask_skip, train), pos_skip, mask_skip
