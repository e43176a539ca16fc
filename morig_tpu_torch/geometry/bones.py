"""Vertex-to-bone distances — counterpart of morig_tpu/geometry/bones.py
(`point_to_segment_dist`), batched."""
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
