"""Kernel k-means over joint feature + euclidean distances — counterpart of
morig_tpu/geometry/kmeans.py: fixed-iteration Lloyd updates as masked
dense matmuls, on the inputs' device.  The initial centroids are drawn by
`draw_kmeans_init` from an explicit generator, apart from the iterations
(`kernel_kmeans_from`), so a test can hand in the JAX package's draw.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from morig_tpu_torch.kernels.neighbors import pairwise_sqdist


def draw_kmeans_init(generator: Optional[torch.Generator], mask: torch.Tensor,
                     num_clusters: int) -> torch.Tensor:
    """(num_clusters,) int64 point indices drawn uniformly, with replacement,
    among the valid points of mask (N,) bool."""
    return torch.multinomial(mask.float(), num_clusters, replacement=True, generator=generator)


def _dist(features, positions, cf, cp, feature_weight, position_weight):
    return (feature_weight * pairwise_sqdist(features[None], cf[None])[0]
            + position_weight * pairwise_sqdist(positions[None], cp[None])[0])


def kernel_kmeans_from(features: torch.Tensor, positions: torch.Tensor, init_idx: torch.Tensor,
                       feature_weight: float = 1.0, position_weight: float = 1.0,
                       num_iter: int = 20, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cluster N points, features (N, C) and positions (N, 3), starting from
    the centroids at `init_idx`: num_iter Lloyd steps over the valid points
    (a cluster left empty keeps its centroid).  Returns (N,) int64
    assignments."""
    num_clusters = init_idx.shape[0]
    valid = torch.ones(features.shape[0], dtype=torch.bool, device=features.device) \
        if mask is None else mask
    cf, cp = features[init_idx], positions[init_idx]
    for _ in range(num_iter):
        assign = _dist(features, positions, cf, cp, feature_weight, position_weight).argmin(1)
        onehot = F.one_hot(assign, num_clusters).to(features.dtype) * valid[:, None]
        count = onehot.sum(0)
        keep = (count > 0)[:, None]
        cnt = torch.clamp(count, min=1e-10)[:, None]
        cf = torch.where(keep, onehot.T @ features / cnt, cf)
        cp = torch.where(keep, onehot.T @ positions / cnt, cp)
    return _dist(features, positions, cf, cp, feature_weight, position_weight).argmin(1)


def kernel_kmeans(features: torch.Tensor, positions: torch.Tensor, num_clusters: int,
                  generator: Optional[torch.Generator], feature_weight: float = 1.0,
                  position_weight: float = 1.0, num_iter: int = 20,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`kernel_kmeans_from` with num_clusters initial centroids drawn from
    `generator` among the valid points."""
    valid = torch.ones(features.shape[0], dtype=torch.bool, device=features.device) \
        if mask is None else mask
    return kernel_kmeans_from(features, positions, draw_kmeans_init(generator, valid, num_clusters),
                              feature_weight, position_weight, num_iter, mask)
