"""Surface geodesics (host) and volumetric vertex-to-bone geodesics —
counterpart of morig_tpu/geometry/geodesic.py.

`fps_numpy` and `surface_geodesic` are host copies: the surface is sampled,
each sample joined to its nearest neighbours whose normals are not opposed,
and all-pairs Dijkstra runs in the repository's C++ code.
`vertex_bone_geodesic` is the one-mesh host form (the line of sight on a
device, the per-bone fallback in numpy), which the rig datasets use;
`vertex_bone_geodesic_device` is the served form, batched over meshes.
"""
from __future__ import annotations

import numpy as np
import torch

from morig_tpu_torch import native
from morig_tpu_torch.data.synthetic import sample_surface
from morig_tpu_torch.geometry.bones import (point_to_segment_dist, prune_far_visible,
                                            vertex_bone_visibility)
from morig_tpu_torch.geometry.voxel import Voxels, segment_inside_fraction, vox_to_device

POS = 1e30


def fps_numpy(pts: np.ndarray, k: int, start: int = 0) -> np.ndarray:
    idx = np.zeros(k, int)
    idx[0] = start
    d = ((pts - pts[start]) ** 2).sum(1)
    for i in range(1, k):
        idx[i] = int(np.argmax(d))
        d = np.minimum(d, ((pts - pts[idx[i]]) ** 2).sum(1))
    return idx


def surface_geodesic(verts: np.ndarray, faces: np.ndarray, num_samples: int = 4000,
                     knn: int = 5, normal_cos_min: float = -0.5,
                     inf_offset: float = 8.0) -> np.ndarray:
    """(V, V) vertex surface-geodesic matrix: farthest-point samples of a
    dense surface sampling, Dijkstra over their normal-filtered kNN graph
    (disconnected pairs: euclidean + inf_offset), pulled back to the
    vertices through each vertex's nearest sample."""
    rng = np.random.default_rng(0)
    n_dense = max(num_samples * 4, 2000)
    dense, fid, _ = sample_surface(verts, faces, n_dense, rng)
    num_samples = min(num_samples, len(dense))
    sel = fps_numpy(dense, num_samples)
    pts = dense[sel]
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    normals = fn[fid[sel]]
    dist = native.geodesic_all_pairs(pts, normals, knn, normal_cos_min, inf_offset)
    v2s = np.argmin(np.sqrt(((verts[:, None] - pts[None]) ** 2).sum(-1)), axis=1)
    return dist[v2s][:, v2s].astype(np.float32)


def vertex_bone_geodesic(verts: np.ndarray, bones: np.ndarray, vox: Voxels,
                         surface_geo: np.ndarray | None = None, faces: np.ndarray | None = None,
                         inside_threshold: float = 0.90, inf_offset: float = 8.0,
                         device="cuda") -> np.ndarray:
    """(V, B) float64 volumetric geodesic from every vertex to every bone
    (B, 6) of one mesh.  A pair in voxel line of sight (at least
    `inside_threshold` of its samples inside `vox`, computed on `device`),
    and not farther than 1.3 x its bone's 15th-percentile visible distance
    (`prune_far_visible`), takes the straight point-to-segment distance; an
    occluded pair takes the surface geodesic to its nearest visible vertex
    plus that vertex's distance (inf_offset + the straight distance where
    the surface does not connect them); a bone no vertex sees takes the
    straight distance.  The surface geodesics come from `faces` when not
    given."""
    grid, tr, sc = vox_to_device([vox], device)
    visible, dist = vertex_bone_visibility(
        torch.as_tensor(verts, dtype=torch.float32, device=device)[None],
        torch.as_tensor(bones, dtype=torch.float32, device=device)[None],
        grid, tr, sc, inside_threshold=inside_threshold)
    dist = dist[0].cpu().numpy().astype(np.float64)
    visible = prune_far_visible(visible[0].cpu().numpy(), dist)
    if surface_geo is None:
        if faces is None:
            raise ValueError("vertex_bone_geodesic needs faces or surface_geo")
        surface_geo = surface_geodesic(verts, faces)

    out = np.where(visible, dist, 0.0)
    for b in range(bones.shape[0]):
        vis = np.flatnonzero(visible[:, b])
        occ = np.flatnonzero(~visible[:, b])
        if len(vis) == 0:
            out[:, b] = dist[:, b]
            continue
        if len(occ) == 0:
            continue
        sg = surface_geo[np.ix_(occ, vis)]
        nn = np.argmin(sg, axis=1)
        d1 = sg[np.arange(len(occ)), nn]
        out[occ, b] = np.where(np.isfinite(d1), d1 + out[vis[nn], b], inf_offset + dist[occ, b])
    return out


def _percentile_threshold(vis, dist, percentile: float, far_factor: float):
    """Per bone: far_factor x the `percentile` order statistic of the visible
    distances over axis 1 (index truncated from percentile * (n - 1)), POS
    where no vertex sees the bone.  vis, dist (B,N,M) -> ((B,M), n_vis)."""
    N = dist.shape[1]
    d_sorted = torch.sort(torch.where(vis, dist, torch.full_like(dist, POS)), dim=1).values
    n_vis = vis.sum(1)
    k_idx = (percentile * (n_vis - 1).float()).to(torch.int64).clamp(0, N - 1)
    thr = torch.gather(d_sorted, 1, k_idx[:, None, :])[:, 0]
    return far_factor * torch.where(n_vis > 0, thr, torch.full_like(thr, POS)), n_vis


def _min_plus(sg_rows, dvis, bone_chunk: int):
    """min over anchors a of sg_rows[b, a, v] + dvis[b, a, m] in the working
    type (bf16), bones in chunks of bone_chunk to bound the (B, A, V, chunk)
    buffer.  sg_rows (B,A,V), dvis (B,A,M) -> (B,V,M) fp32."""
    return torch.cat([(sg_rows[..., None] + dvis[:, :, None, c:c + bone_chunk]).amin(1)
                      for c in range(0, dvis.shape[2], bone_chunk)], -1).float()


@torch.no_grad()
def vertex_bone_geodesic_device(verts, bones, bone_mask, surf_geo, grid, translate, scale,
                                inside_threshold: float = 0.90, inf_offset: float = 8.0,
                                percentile: float = 0.15, far_factor: float = 1.3,
                                bone_chunk: int = 8, num_anchors=None, los_samples: int = 32,
                                num_candidates=None):
    """Volumetric vertex-to-bone geodesic over padded bones, batched:
    verts (B,V,3), bones (B,M,6), bone_mask (B,M), surf_geo (B,V,V) (bf16
    in the served path), voxel triple -> (B,V,M) fp32, padded bones POS.

    A (vertex, bone) pair in voxel line of sight, and not farther than
    far_factor x the bone's `percentile` visible distance, takes the
    straight distance; an occluded pair takes min over visible anchors u of
    surf_geo[v, u] + dist[u, bone], capped at inf_offset + the straight
    distance; a bone no vertex sees takes the straight distance.  The
    anchors are every stride-th vertex (stride V // num_anchors; all
    vertices when num_anchors is None).  With num_candidates < M (and
    num_anchors), only each vertex's num_candidates euclidean-nearest bones
    are cast and filled (the rest are POS), and the percentile statistic
    comes from the anchors' rays."""
    V = verts.shape[1]
    M = bones.shape[1]
    stride = max(V // num_anchors, 1) if num_anchors is not None and num_anchors < V else 1
    sg_rows = surf_geo[:, ::stride]                                  # (B,A,V)
    bm = bone_mask[:, None, :]

    if not (num_candidates is not None and num_candidates < M and num_anchors is not None):
        visible, dist = vertex_bone_visibility(verts, bones, grid, translate, scale,
                                               los_samples, inside_threshold)
        visible = visible & bm
        far_thr, n_vis = _percentile_threshold(visible, dist, percentile, far_factor)
        visible = visible & (dist <= far_thr[:, None, :])
        dvis = torch.where(visible, dist, torch.full_like(dist, POS)).to(surf_geo.dtype)
        fb = _min_plus(sg_rows, dvis[:, ::stride], bone_chunk)
        geo = torch.where(visible, dist, torch.minimum(fb, inf_offset + dist))
        geo = torch.where(visible.any(1, keepdim=True), geo, dist)
        return torch.where(bm, geo, torch.full_like(geo, POS))

    # candidate-restricted rays: the anchors' rays to every bone give the
    # percentile statistic and the min-plus sources; each vertex casts only
    # to its num_candidates euclidean-nearest bones
    Kc = num_candidates
    dist, foot = point_to_segment_dist(verts, bones)                 # (B,V,M)
    dist = torch.where(bm, dist, torch.full_like(dist, POS))
    averts, dist_a, foot_a = verts[:, ::stride], dist[:, ::stride], foot[:, ::stride]
    frac_a = segment_inside_fraction(averts[:, :, None, :].expand_as(foot_a), foot_a,
                                     grid, translate, scale, los_samples)
    vis_a = (frac_a >= inside_threshold) & bm
    far_thr, n_vis = _percentile_threshold(vis_a, dist_a, percentile, far_factor)
    vis_a = vis_a & (dist_a <= far_thr[:, None, :])

    # the Kc nearest, ties to the lower index (lax.top_k order): a stable sort
    dist_c, cidx = torch.sort(dist, dim=-1, stable=True)
    dist_c, cidx = dist_c[..., :Kc], cidx[..., :Kc]                  # (B,V,Kc)
    foot_c = torch.gather(foot, 2, cidx[..., None].expand(-1, -1, -1, 3))
    frac_c = segment_inside_fraction(verts[:, :, None, :].expand_as(foot_c), foot_c,
                                     grid, translate, scale, los_samples)
    cmask = torch.gather(bm.expand(-1, V, -1), 2, cidx)
    far_c = torch.gather(far_thr[:, None, :].expand(-1, V, -1), 2, cidx)
    vis_c = (frac_c >= inside_threshold) & cmask & (dist_c <= far_c)

    dvis_a = torch.where(vis_a, dist_a, torch.full_like(dist_a, POS)).to(surf_geo.dtype)
    fb_c = torch.gather(_min_plus(sg_rows, dvis_a, bone_chunk), 2, cidx)
    any_vis = torch.gather((n_vis > 0)[:, None, :].expand(-1, V, -1), 2, cidx)
    geo_c = torch.where(vis_c, dist_c, torch.minimum(fb_c, inf_offset + dist_c))
    geo_c = torch.where(any_vis, geo_c, dist_c)
    geo_c = torch.where(cmask, geo_c, torch.full_like(geo_c, POS))
    return torch.full_like(dist, POS).scatter(2, cidx, geo_c)
