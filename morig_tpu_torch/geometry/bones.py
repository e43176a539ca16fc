"""Vertex-to-bone distances, voxel line of sight and the skin descriptors —
counterpart of morig_tpu/geometry/bones.py: `point_to_segment_dist` and
`vertex_bone_visibility` batched on the device; `prune_far_visible`,
`pack_skin_descriptors` and `scatter_skin_full` numpy copies for the host
geodesic and the single-mesh skin stage."""
from __future__ import annotations

import numpy as np
import torch


def point_to_segment_dist(pts: torch.Tensor, bones: torch.Tensor):
    """pts (B,N,3), bones (B,M,6) [start | end] -> (dist (B,N,M), foot
    (B,N,M,3)), foot being the closest point on each segment."""
    a, b = bones[..., :3], bones[..., 3:]
    ab = b - a                                                  # (B,M,3)
    l2 = (ab * ab).sum(-1)[:, None, :]                          # (B,1,M)
    ap = pts[:, :, None, :] - a[:, None, :, :]                  # (B,N,M,3)
    t = (ap * ab[:, None]).sum(-1) / torch.clamp(l2, min=1e-8)
    t = torch.where(l2 < 1e-8, torch.zeros_like(t), torch.clamp(t, 0.0, 1.0))
    foot = a[:, None] + t[..., None] * ab[:, None]
    return torch.linalg.norm(pts[:, :, None, :] - foot, dim=-1), foot


def vertex_bone_visibility(verts, bones, grid, translate, scale, num_samples: int = 32,
                           inside_threshold: float = 0.95):
    """Voxel line of sight: (vertex, closest point on the bone) segments of
    which at least `inside_threshold` of the samples lie inside the grid.
    verts (B,V,3), bones (B,M,6) -> (visible (B,V,M) bool, dist (B,V,M))."""
    from morig_tpu_torch.geometry.voxel import segment_inside_fraction

    dist, foot = point_to_segment_dist(verts, bones)
    starts = verts[:, :, None, :].expand_as(foot)
    frac = segment_inside_fraction(starts, foot, grid, translate, scale, num_samples)
    return frac >= inside_threshold, dist


def prune_far_visible(visible: np.ndarray, dist: np.ndarray, percentile: float = 15.0,
                      factor: float = 1.3) -> np.ndarray:
    """visible (V, B) with the pairs farther than `factor` x their bone's
    `percentile`-th visible distance (np.percentile, linear) dropped."""
    out = visible.copy()
    for b in range(visible.shape[1]):
        vis_d = dist[visible[:, b], b]
        if len(vis_d) == 0:
            continue
        out[dist[:, b] > factor * np.percentile(vis_d, percentile), b] = False
    return out


def pack_skin_descriptors(geo_dist: np.ndarray, bones: np.ndarray, bone_isleaf: np.ndarray,
                          num_nearest: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-vertex K-nearest-bone descriptors, (V, K*8) with [6 endpoint
    coords, 1/(dist+1e-10), isleaf] per bone, from geo_dist (V, B).  Returns
    (skin_input (V,K*8) f32, skin_nn (V,K) int32 bone ids, loss_mask (V,K)
    int32, 0 where fewer than K bones exist).  The order among equal
    distances is numpy's default argsort, as in the JAX package."""
    V, B = geo_dist.shape
    K = num_nearest
    order = np.argsort(geo_dist, axis=1)
    k_eff = min(K, B)
    nn = order[:, :k_eff]
    if k_eff < K:
        nn = np.concatenate([nn, np.repeat(order[:, :1], K - k_eff, axis=1)], axis=1)
    mask = np.zeros((V, K), np.int32)
    mask[:, :k_eff] = 1
    d = np.take_along_axis(geo_dist, nn, axis=1)
    desc = np.concatenate([bones[nn].reshape(V, K, 6), (1.0 / (d + 1e-10))[..., None],
                           bone_isleaf[nn].astype(np.float32)[..., None]],
                          axis=-1).reshape(V, K * 8)
    return desc.astype(np.float32), nn.astype(np.int32), mask


def scatter_skin_full(skin_probs: np.ndarray, skin_nn: np.ndarray, loss_mask: np.ndarray,
                      num_bones: int) -> np.ndarray:
    """Per-vertex K-bone probabilities (V, K) onto the full bone axis (V,
    num_bones) float64, repeated bones summed."""
    V, K = skin_probs.shape
    full = np.zeros((V, num_bones), np.float64)
    rows = np.repeat(np.arange(V), K)
    np.add.at(full, (rows, skin_nn.reshape(-1)), (skin_probs * loss_mask).reshape(-1))
    return full
