"""Headless visualization exports — a copy of morig_tpu/eval/visualize.py
(numpy; `smooth_tracking_quats` through the port's
`geometry.rotations.quaternion_to_matrix`, in float32 as the JAX package
runs it).

The reference's visualize_* scripts are interactive open3d viewers
(SURVEY.md §2.12); this environment is headless and open3d-free, so the
equivalents export viewable artifacts instead: colored PLY point clouds
(feature embeddings via PCA colors, attention heat, tracking overlays) and
OBJ skeleton wire meshes.  Any mesh viewer opens the results.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from morig_tpu_torch.geometry.rotations import quaternion_to_matrix
from morig_tpu_torch.geometry.skeleton import Rig


def _write_colored_ply(path: str, pts: np.ndarray, colors: np.ndarray) -> None:
    colors = np.clip(colors * 255, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        hdr = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        f.write(hdr.encode("ascii"))
        rec = np.zeros(len(pts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = pts.astype(np.float32)
        rec["rgb"] = colors
        f.write(rec.tobytes())


def heat_colors(values: np.ndarray) -> np.ndarray:
    """Blue→red heat colormap over min-max-normalized scalars."""
    v = np.asarray(values, np.float64).reshape(-1)
    v = (v - v.min()) / max(v.max() - v.min(), 1e-10)
    return np.stack([v, 0.2 * np.ones_like(v), 1.0 - v], axis=1)


def feature_colors(features: np.ndarray) -> np.ndarray:
    """PCA of embeddings to RGB (the t-SNE coloring of visualize_corr, done
    deterministically)."""
    f = features - features.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(f, full_matrices=False)
    proj = f @ vt[:3].T
    lo, hi = proj.min(0), proj.max(0)
    return (proj - lo) / np.maximum(hi - lo, 1e-10)


def label_colormap(n: int) -> np.ndarray:
    """n visually-distinct label colors in [0,1] (golden-ratio hue walk with
    alternating saturation/value tiers).  Serves the role of the reference's
    ADE20K/cityscapes label tables (utils/colormaps.py, used by
    utils/vis_utils.py:127-180 to color skin/segment assignments) without
    shipping a 263-line constant table."""
    import colorsys

    phi = 0.61803398875
    out = np.zeros((n, 3))
    for i in range(n):
        h = (i * phi) % 1.0
        s = (0.85, 0.55)[i % 2]
        v = (0.95, 0.7)[(i // 2) % 2]
        out[i] = colorsys.hsv_to_rgb(h, s, v)
    return out


def skin_colors(skins: np.ndarray) -> np.ndarray:
    """Per-vertex color of the dominant skinning label (vis_utils.py:127
    usage pattern): argmax joint -> label colormap."""
    cmap = label_colormap(skins.shape[1])
    return cmap[np.argmax(skins, axis=1)]


def export_skinning(path: str, verts: np.ndarray, skins: np.ndarray) -> None:
    """Skinning visualization: vertices colored by dominant joint."""
    _write_colored_ply(path, verts, skin_colors(skins))


def smooth_tracking_quats(rig: Rig, rest_verts: np.ndarray,
                          quats: np.ndarray, num_pass: int = 2, device="cuda"):
    """Temporal quaternion smoothing + re-posing of the tracked mesh
    (visualize_tracking.py:43-61): two passes of the 1-2-1-style neighbor
    average over time, then FK + LBS from joint-local rest coordinates.

    quats (J, T, 4) per-joint local rotations; returns
    (vtx_traj (V, T, 3), smoothed quats).  The rotation matrices of all
    frames are made in one call on `device` (the card unless the caller
    asks for another)."""
    quats = np.array(quats, np.float64)
    # hemisphere-align adjacent frames first: q and -q encode the same
    # rotation, but averaging q with -q cancels to ~0 and normalizes to
    # garbage.  Walk the sequence flipping each frame's sign to match its
    # predecessor (per joint).
    for t in range(1, quats.shape[1]):
        flip = (quats[:, t] * quats[:, t - 1]).sum(-1) < 0.0   # (J,)
        quats[flip, t, :] *= -1.0
    for _ in range(num_pass):
        quats[:, 1:-1, :] = (quats[:, 1:-1, :] + 0.5 * quats[:, 2:, :]
                             + 0.5 * quats[:, :-2, :]) / 2.0
    quats /= np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)

    T = quats.shape[1]
    traj = np.zeros((len(rest_verts), T, 3), np.float32)
    # joint-local rest coordinates under the identity pose
    rel = rest_verts[:, None, :] - rig.pos[None, :, :]          # (V, J, 3)
    Rs = quaternion_to_matrix(torch.as_tensor(quats, dtype=torch.float32,
                                              device=device)).cpu().numpy()   # (J, T, 3, 3)
    for t in range(T):
        G, q = rig.fk(Rs[:, t])
        moved = np.einsum("jab,vjb->vja", G, rel) + q[None]
        traj[:, t, :] = np.einsum("vj,vja->va", rig.skins, moved)
    return traj, quats


def export_attention(path: str, verts: np.ndarray, attn: np.ndarray) -> None:
    """visualize_attn equivalent: vertices heat-colored by attention."""
    _write_colored_ply(path, verts, heat_colors(attn))


def export_correspondence(path_vtx: str, path_pts: str,
                          verts: np.ndarray, vtx_feat: np.ndarray,
                          pts: np.ndarray, pts_feat: np.ndarray) -> None:
    """visualize_corr equivalent: matching embedding colors on both clouds."""
    both = np.concatenate([vtx_feat, pts_feat], axis=0)
    colors = feature_colors(both)
    _write_colored_ply(path_vtx, verts, colors[: len(verts)])
    _write_colored_ply(path_pts, pts, colors[len(verts):])


def export_flow(path: str, verts: np.ndarray, flow: np.ndarray) -> None:
    """visualize_deform equivalent: source (blue) + flowed (red) clouds."""
    pts = np.concatenate([verts, verts + flow], axis=0)
    colors = np.concatenate([
        np.tile([[0.2, 0.2, 1.0]], (len(verts), 1)),
        np.tile([[1.0, 0.2, 0.2]], (len(verts), 1)),
    ])
    _write_colored_ply(path, pts, colors)


def export_skeleton_obj(path: str, rig: Rig, samples_per_bone: int = 12) -> None:
    """visualize_rig equivalent: skeleton as an OBJ polyline point set plus
    joint markers (sphere-free, viewer-agnostic)."""
    lines = []
    for j in range(rig.num_joints):
        p = rig.parents[j]
        if p >= 0:
            t = np.linspace(0, 1, samples_per_bone)[:, None]
            lines.append(rig.pos[p][None] + t * (rig.pos[j] - rig.pos[p])[None])
    pts = np.concatenate([rig.pos] + lines, axis=0) if lines else rig.pos
    with open(path, "w") as f:
        for v in pts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")


def export_tracking(folder: str, name: str, pred_traj: np.ndarray,
                    pts_traj: np.ndarray, stride: int = 10) -> None:
    """visualize_tracking equivalent: per-frame overlay PLYs (pred red,
    observed points blue) every `stride` frames."""
    os.makedirs(folder, exist_ok=True)
    T = pred_traj.shape[1]
    for t in range(0, T, stride):
        pts = np.concatenate([pred_traj[:, t, :], pts_traj[:, t, :]], axis=0)
        colors = np.concatenate([
            np.tile([[1.0, 0.2, 0.2]], (pred_traj.shape[0], 1)),
            np.tile([[0.2, 0.2, 1.0]], (pts_traj.shape[0], 1)),
        ])
        _write_colored_ply(os.path.join(folder, f"{name}_frame{t:03d}.ply"), pts, colors)
