"""PointNet++ set abstraction / feature propagation — counterpart of
morig_tpu/nn/pointnet.py (SAModule, GlobalSAModule, FPModule).

FPS starts where the caller says (index 0, the eval start, by default);
radius grouping keeps the exact nearest neighbors.  At inference the row
gathers run in kernel K3; in training they are plain, differentiable
indexed gathers, as the JAX package keeps its gather kernel for inference.
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
        gather = _gather(train)
        idx = nbk.fps(pos, num_out, mask, start)
        new_pos = torch.gather(pos, 1, idx[..., None].expand(-1, -1, 3))
        new_mask = torch.gather(mask, 1, idx)
        grp_idx, grp_valid = nbk.radius_group(new_pos, pos, self.radius,
                                              self.max_neighbors, mask)
        if x is None:
            feat_in = gather(pos, grp_idx) - new_pos[:, :, None, :]
        else:
            g = gather(torch.cat([x, pos], -1), grp_idx)
            C = x.shape[-1]
            feat_in = torch.cat([g[..., :C], g[..., C:] - new_pos[:, :, None, :]], -1)
        grp_valid = grp_valid & new_mask[:, :, None]
        new_x = nbk.masked_max(self.conv(feat_in, train), grp_valid, dim=2)
        return new_x, new_pos, new_mask


class GlobalSAModule(nn.Module):
    """Global max-pool abstraction over MLP([x, pos])."""

    def __init__(self, fin: int, mlp_channels: Sequence[int]):
        super().__init__()
        self.nn = MLP(fin + 3, mlp_channels)

    def forward(self, x, pos, mask, train: bool = False):
        return nbk.masked_max(self.nn(torch.cat([x, pos], -1), train), mask, dim=1)


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
            idx, negd2 = nbk.knn(pos_skip, pos, self.k, cand_mask=mask)
            w = 1.0 / (torch.clamp(-negd2, min=0.0) + 1e-8)
            w = w / w.sum(-1, keepdim=True)
            up = (_gather(train)(x, idx) * w[..., None]).sum(2)
        if x_skip is not None:
            up = torch.cat([up, x_skip], -1)
        return self.nn(up, train), pos_skip, mask_skip
