"""Preprocessing: a raw mesh (and rig) to the arrays the datasets and the
served path read — counterpart of morig_tpu/data/preprocess.py (host,
numpy, the repository's C++ code through `morig_tpu_torch.native`).

One-ring and geodesic-ball edge tables, mesh normalization, voxelization,
the GT attention mask, the voxel-BFS and volumetric vertex-to-bone
geodesics, `preprocess_model` with its per-model skip-if-exists cache
(.npz and .binvox files), and the reverse Cuthill-McKee vertex order that
makes a mesh local enough for the windowed edge kernel K5
(kernels/edge_fused.py `check_neighbor_locality`).  There is no Python
fallback for the C++ code: a host without g++ raises.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from morig_tpu_torch import native
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.geodesic import surface_geodesic, vertex_bone_geodesic
from morig_tpu_torch.geometry.voxel import Voxels, read_binvox, voxelize_mesh, write_binvox


def get_tpl_edges(faces: np.ndarray) -> np.ndarray:
    """(E, 2) int64 unique one-ring edges (i < j, sorted) of triangles."""
    return native.one_ring_edges(np.asarray(faces, np.int32)).astype(np.int64)


def get_geo_edges(surface_geo: np.ndarray, radius: float = 0.06,
                  max_nn: int = 15, seed: int = 0) -> np.ndarray:
    """Geodesic-ball edges: for each vertex, the others within `radius` of
    it on the surface, at most `max_nn` of them (drawn without replacement
    from a generator seeded `seed` where the ball holds more)."""
    rng = np.random.default_rng(seed)
    n = len(surface_geo)
    g = surface_geo + 10.0 * np.eye(n)
    rows = []
    for i in range(n):
        ball = np.argwhere(g[i] <= radius).reshape(-1)
        if len(ball) > max_nn:
            ball = rng.choice(ball, max_nn, replace=False)
        if len(ball):
            rows.append(np.stack([np.full(len(ball), i), ball], axis=1))
    if not rows:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(rows, axis=0).astype(np.int64)


def normalize_mesh(verts: np.ndarray):
    """Center on the footprint (x and z mid-range, y minimum) and scale the
    largest extent to 1.  Returns (verts, pivot, scale)."""
    lo, hi = verts.min(0), verts.max(0)
    scale = 1.0 / max(hi - lo)
    pivot = np.array([(lo[0] + hi[0]) / 2, lo[1], (lo[2] + hi[2]) / 2])
    return (verts - pivot) * scale, pivot, scale


def gt_attention_mask(verts: np.ndarray, rig: sk.Rig, radius: float = 0.08) -> np.ndarray:
    """The GT joint attention: 1 for vertices within `radius` of a joint."""
    d = np.linalg.norm(verts[:, None] - rig.pos[None], axis=-1).min(1)
    return (d < radius).astype(np.float32)


def volumetric_geodesic_bfs(verts: np.ndarray, vox: Voxels, bones: np.ndarray) -> np.ndarray:
    """(V, B) float64 vertex-to-bone distance in dilation steps through the
    solid voxels (-1 where unreachable): each bone sampled every 0.01 as
    seeds, each vertex read at its voxel."""
    d = vox.dims
    vtx_vox = np.clip(np.round((verts - vox.translate) / vox.scale * d).astype(int), 0, d - 1)
    out = np.zeros((len(verts), len(bones)), np.float64)
    for b, bone in enumerate(bones):
        n = max(int(np.linalg.norm(bone[3:] - bone[:3]) / 0.01), 1)
        t = np.linspace(0, 1, n + 1)[:, None]
        samples = bone[None, :3] + t * (bone[3:] - bone[:3])[None]
        seeds = np.clip(np.round((samples - vox.translate) / vox.scale * d).astype(np.int32),
                        0, d - 1)
        dist = native.voxel_bfs(vox.data, seeds)
        out[:, b] = dist[vtx_vox[:, 0], vtx_vox[:, 1], vtx_vox[:, 2]]
    return out


def preprocess_model(verts: np.ndarray, faces: np.ndarray, rig: Optional[sk.Rig] = None,
                     cache_dir: Optional[str] = None, name: str = "model", vox_dims: int = 88,
                     geo_radius: float = 0.06, geo_max_nn: int = 15, device="cuda") -> dict:
    """One mesh's preprocessing: edge tables, surface geodesics and the voxel
    grid, and with a GT `rig` the attention mask, the bones and the
    volumetric vertex-to-bone geodesic (its line of sight on `device`, the
    card unless the caller asks for another).  With `cache_dir`, each array
    is read from `{name}_tpl.npz`, `_sgeo.npz`, `_geo.npz`, `_vbgeo.npz` and
    `{name}.binvox` there when the file exists, else computed and written."""

    def cache(fname, fn):
        if cache_dir is None:
            return fn()
        full = os.path.join(cache_dir, fname)
        if os.path.exists(full):
            return np.load(full)["arr_0"]
        os.makedirs(cache_dir, exist_ok=True)
        out = fn()
        np.savez_compressed(full, out)
        return out

    tpl = cache(f"{name}_tpl.npz", lambda: get_tpl_edges(faces))
    sgeo = cache(f"{name}_sgeo.npz", lambda: surface_geodesic(verts, faces))
    geo = cache(f"{name}_geo.npz", lambda: get_geo_edges(sgeo, geo_radius, geo_max_nn))

    vox_path = os.path.join(cache_dir, f"{name}.binvox") if cache_dir else None
    if vox_path and os.path.exists(vox_path):
        vox = read_binvox(vox_path)
    else:
        vox = voxelize_mesh(verts, faces, dims=vox_dims)
        if vox_path:
            write_binvox(vox, vox_path)

    out = dict(tpl_edges=tpl, geo_edges=geo, surface_geodesic=sgeo, vox=vox)
    if rig is not None:
        bones, bone_names, isleaf = sk.get_bones(rig)
        out["attn"] = gt_attention_mask(verts, rig)
        out["vertex_bone_geodesic"] = cache(
            f"{name}_vbgeo.npz",
            lambda: vertex_bone_geodesic(verts, bones, vox, surface_geo=sgeo, device=device))
        out["bones"], out["bone_names"], out["bone_isleaf"] = bones, bone_names, isleaf
    return out


def rcm_vertex_order(num_verts: int, tpl_edges: np.ndarray,
                     geo_edges: np.ndarray) -> np.ndarray:
    """Bandwidth-reducing vertex order (reverse Cuthill-McKee) over the union
    of both edge sets: neighbour index distance is then bounded by the
    graph's bandwidth instead of V.  Returns `order` such that
    new_verts = verts[order]."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    e = np.concatenate([tpl_edges, geo_edges], axis=0).astype(np.int64)
    e = e[(e[:, 0] < num_verts) & (e[:, 1] < num_verts)]
    data = np.ones(len(e) * 2)
    rows = np.concatenate([e[:, 0], e[:, 1]])
    cols = np.concatenate([e[:, 1], e[:, 0]])
    A = coo_matrix((data, (rows, cols)), shape=(num_verts, num_verts)).tocsr()
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def apply_vertex_order(order: np.ndarray, verts: np.ndarray, tpl_edges: np.ndarray,
                       geo_edges: np.ndarray, *per_vertex_arrays: np.ndarray):
    """Permute a mesh (and any per-vertex arrays) into `order`; edge indices
    are remapped.  Returns (verts, tpl_edges, geo_edges, *arrays)."""
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    out_tpl = inv[tpl_edges.astype(np.int64)]
    out_geo = inv[geo_edges.astype(np.int64)]
    outs = tuple(a[order] for a in per_vertex_arrays)
    return (verts[order], out_tpl, out_geo) + outs
