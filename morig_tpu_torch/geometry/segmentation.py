"""Segmentation symmetry/boundary helpers (data preparation) — a copy of
morig_tpu/geometry/segmentation.py (numpy) on the port's `Rig`.

Replaces utils/mst_utils.py:324-452: choosing the better-clustered half of a
symmetric mesh, mirroring segment labels across the symmetry plane, and
snapping joints to segment boundaries — used when generating GT rigs from
segmentations.
"""
from __future__ import annotations

import numpy as np

from morig_tpu_torch.eval.metrics import chamfer_dist
from morig_tpu_torch.geometry.skeleton import Rig


def tpl_adjacency(num_verts: int, faces: np.ndarray) -> np.ndarray:
    A = np.zeros((num_verts, num_verts), bool)
    for a, b in [(0, 1), (1, 2), (0, 2)]:
        A[faces[:, a], faces[:, b]] = True
    return A | A.T


def segment_compactness_side(labels: np.ndarray, verts: np.ndarray) -> str:
    """Which half (left/right of x=0) has the more compact segmentation —
    the side whose labels to preserve when mirroring (mst_utils.py:324-336)."""
    def score(vid):
        if len(vid) == 0:
            return np.inf
        centers = []
        for l in np.unique(labels[vid]):
            sel = vid[labels[vid] == l]
            centers.append(verts[sel].mean(0))
        return chamfer_dist(verts[vid], np.asarray(centers))

    left = np.argwhere(verts[:, 0] <= 0).reshape(-1)
    right = np.argwhere(verts[:, 0] > 0).reshape(-1)
    return "left" if score(left) < score(right) else "right"


def mirror_segmentation(labels: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                        match_tol: float = 0.05) -> np.ndarray:
    """Mirror per-vertex segment labels from the better half to the other,
    merging mirrored segments back when topologically adjacent
    (flip_seg, mst_utils.py:349-395)."""
    labels = np.asarray(labels).copy()
    num_label = labels.max()
    adj = tpl_adjacency(len(verts), faces)
    side = segment_compactness_side(labels, verts)
    if side == "left":
        vid_src = np.argwhere(verts[:, 0] <= 0).reshape(-1)
        vid_tar = np.argwhere(verts[:, 0] > 0).reshape(-1)
    else:
        vid_src = np.argwhere(verts[:, 0] > 0).reshape(-1)
        vid_tar = np.argwhere(verts[:, 0] <= 0).reshape(-1)
    src_reflect = verts[vid_src] * np.array([[-1, 1, 1]])
    d = np.linalg.norm(verts[vid_tar][:, None] - src_reflect[None], axis=-1)
    nn = d.argmin(1)
    ok = d.min(1) < match_tol
    labels[vid_tar[ok]] = labels[vid_src][nn[ok]] + num_label + 1
    for l_src in np.unique(labels[vid_src]):
        a = np.argwhere(labels == l_src).reshape(-1)
        b = np.argwhere(labels == l_src + num_label + 1).reshape(-1)
        if len(a) and len(b) and adj[np.ix_(a, b)].any():
            labels[b] = l_src
    return labels


def boundary_pivot(v_parent: np.ndarray, v_children: np.ndarray,
                   percentile: float = 5.0) -> np.ndarray:
    """Mean position of the closest cross-segment point pairs — the joint
    pivot between two segments (get_pivot, mst_utils.py:398-425)."""
    if len(v_parent) == 0 or len(v_children) == 0:
        return np.concatenate([v_parent, v_children]).mean(0)
    d = np.linalg.norm(v_parent[:, None] - v_children[None], axis=-1)
    close = np.argwhere(d < np.percentile(d, percentile))
    if len(close) == 0:
        return np.concatenate([v_children, v_parent]).mean(0)
    pa = v_parent[np.unique(close[:, 0])]
    ch = v_children[np.unique(close[:, 1])]
    return np.concatenate([pa, ch]).mean(0)


def move_joints_to_boundary(rig: Rig, verts: np.ndarray, labels: np.ndarray) -> Rig:
    """Snap each joint to the boundary between its segment and its parent's
    (mst_utils.py:428-452; sampling replaced by direct vertex sets)."""
    pos = rig.pos.copy()
    root = rig.root_id
    sel = labels == root
    if sel.any():
        pos[root] = verts[sel].mean(0)
    for level in rig.levels():
        for p in level:
            for c in rig.children(int(p)):
                vp = verts[labels == p]
                vc = verts[labels == c]
                if len(vp) and len(vc):
                    pos[c] = boundary_pivot(vp, vc)
    out = Rig(names=list(rig.names), pos=pos, parents=rig.parents.copy(),
              skins=rig.skins)
    return out
