"""Vertex-to-bone distances and voxel line of sight — counterpart of
morig_tpu/geometry/bones.py (`point_to_segment_dist`,
`vertex_bone_visibility`), batched."""
from __future__ import annotations

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
