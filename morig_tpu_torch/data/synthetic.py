"""Synthetic rigged-capsule fixture (numpy) — counterpart of
morig_tpu/data/synthetic.py, carried here so the port stands without the
JAX package.

A UV sphere stretched into a capsule along +y, rigged with a 3-joint chain,
skinned by height and animated by bending at the middle joint; each frame
gives the deformed vertices, a partial point cloud seen from +z, the
vertex visibility and vertex/point correspondences.  Same
generator, same random stream: for a seed the arrays equal the JAX
package's.  `capsule_batch` turns B sequences into the padded mesh entries
and (T, P, 3) keyframe clouds `RigPredictor.predict_rig_batch` takes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from morig_tpu_torch.core.batch import build_mesh


@dataclasses.dataclass
class CapsuleRig:
    verts: np.ndarray          # (V, 3) rest pose
    faces: np.ndarray          # (F, 3)
    tpl_edges: np.ndarray      # (E, 2)
    geo_edges: np.ndarray      # (E2, 2)
    joints: np.ndarray         # (J, 3)
    parents: np.ndarray        # (J,) parent index, -1 for root
    skins: np.ndarray          # (V, J) rows sum to 1


def uv_capsule(n_lat: int = 17, n_lon: int = 16, radius: float = 0.12, height: float = 0.55):
    """Capsule along +y: bottom hemisphere, cylindrical barrel, top hemisphere,
    with rings spaced by arc length so the barrel has real vertices."""
    cap_arc = 0.5 * np.pi * radius
    total = 2 * cap_arc + height
    n_rings = max(n_lat - 1, 3)
    s = np.arange(1, n_rings + 1) / (n_rings + 1) * total

    verts = [[0.0, -radius, 0.0]]
    for si in s:
        if si < cap_arc:                       # bottom hemisphere
            th = -np.pi / 2 + si / radius
            y, rr = radius * np.sin(th), radius * np.cos(th)
        elif si < cap_arc + height:            # barrel
            y, rr = si - cap_arc, radius
        else:                                  # top hemisphere
            th = (si - cap_arc - height) / radius
            y, rr = height + radius * np.sin(th), radius * np.cos(th)
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            verts.append([rr * np.cos(phi), y, rr * np.sin(phi)])
    verts.append([0.0, radius + height, 0.0])
    verts = np.asarray(verts, dtype=np.float32)

    faces = []
    top = len(verts) - 1

    def ring(i, j):
        return 1 + i * n_lon + (j % n_lon)

    for j in range(n_lon):
        faces.append([0, ring(0, j + 1), ring(0, j)])
        faces.append([top, ring(n_rings - 1, j), ring(n_rings - 1, j + 1)])
    for i in range(n_rings - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, np.asarray(faces, dtype=np.int32)


def tpl_edges_from_faces(faces: np.ndarray) -> np.ndarray:
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]], axis=0)
    return np.unique(np.sort(e, axis=1), axis=0)


def geo_edges_knn(verts: np.ndarray, k: int = 6) -> np.ndarray:
    """Euclidean-kNN stand-in for geodesic-ball edges."""
    d = np.linalg.norm(verts[:, None] - verts[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, axis=1)[:, :k]
    rows = np.repeat(np.arange(len(verts)), k)
    return np.stack([rows, nn.reshape(-1)], axis=1)


def make_capsule_rig(n_lat: int = 17, n_lon: int = 16) -> CapsuleRig:
    verts, faces = uv_capsule(n_lat, n_lon)
    height = 0.55
    joints = np.array([[0, 0.0, 0], [0, height * 0.5, 0], [0, height, 0]], dtype=np.float32)
    parents = np.array([-1, 0, 1], dtype=np.int32)
    d = np.abs(verts[:, 1:2] - joints[None, :, 1])             # (V, J)
    w = np.exp(-(d / 0.12) ** 2)
    skins = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    return CapsuleRig(verts=verts, faces=faces, tpl_edges=tpl_edges_from_faces(faces),
                      geo_edges=geo_edges_knn(verts), joints=joints, parents=parents,
                      skins=skins)


def rotz(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


def fk_numpy(joints, parents, local_rots):
    """Global rotations G_j = G_parent R_j and positions q_j = q_parent +
    G_parent (p_j - p_parent), walking the hierarchy breadth first."""
    J = len(joints)
    order = []
    todo = [int(np.argwhere(parents < 0)[0, 0])]
    while todo:
        j = todo.pop(0)
        order.append(j)
        todo += [int(c) for c in np.argwhere(parents == j).reshape(-1)]
    G = np.zeros((J, 3, 3), np.float32)
    q = np.zeros((J, 3), np.float32)
    for j in order:
        p = parents[j]
        if p < 0:
            G[j], q[j] = local_rots[j], joints[j]
        else:
            G[j] = G[p] @ local_rots[j]
            q[j] = q[p] + G[p] @ (joints[j] - joints[p])
    return G, q


def lbs_numpy(verts, joints, parents, skins, local_rots):
    """Linear blend skinning from rest pose: v' = sum_j w_j (G_j (v - p_j) + q_j)."""
    G, q = fk_numpy(joints, parents, local_rots)
    rel = verts[:, None, :] - joints[None, :, :]           # (V, J, 3)
    moved = np.einsum("jab,vjb->vja", G, rel) + q[None]    # (V, J, 3)
    return np.einsum("vj,vja->va", skins, moved)


def sample_surface(verts, faces, n, rng):
    """Area-weighted barycentric surface sampling; returns pts, face ids, barys."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    fid = rng.choice(len(faces), size=n, p=area / area.sum())
    u, v = rng.random(n), rng.random(n)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    bary = np.stack([1 - u - v, u, v], axis=1).astype(np.float32)
    pts = (verts[faces[fid]] * bary[..., None]).sum(axis=1)
    return pts.astype(np.float32), fid, bary


def make_capsule_sequence(num_frames: int = 21, num_points: int = 1024, max_bend: float = 0.9,
                          partial: bool = True, seed: int = 0, n_lat: int = 17,
                          n_lon: int = 16) -> dict:
    """An animated capsule with the raw per-model fields of the pose
    datasets: vtx_traj (V,T,3), pts_traj (P,T,3) clouds refilled to P points
    (partial: the front half seen from +z; else the whole surface),
    corr_v2p / corr_p2v (N,3) int32 [vertex, point, frame] / [point,
    vertex, frame] pairs (every 4th point with its nearest vertex), vismask
    (V,T) f32, tpl_edges, geo_edges and the rig."""
    rng = np.random.default_rng(seed)
    rig = make_capsule_rig(n_lat, n_lon)
    V, T = len(rig.verts), num_frames

    pts0, fid, bary = sample_surface(rig.verts, rig.faces, num_points, rng)
    pt_skins = (rig.skins[rig.faces[fid]] * bary[..., None]).sum(axis=1)
    pt_nn_vert = rig.faces[fid, np.argmax(bary, axis=1)]       # max-bary corner

    vtx_traj = np.zeros((V, T, 3), np.float32)
    pts_traj = np.zeros((num_points, T, 3), np.float32)
    vis = np.zeros((V, T), np.float32)
    corr_v2p, corr_p2v = [], []
    for t in range(T):
        ang = max_bend * np.sin(np.pi * t / (T - 1)) if T > 1 else 0.0
        locals_ = np.stack([np.eye(3, dtype=np.float32), rotz(ang), rotz(ang * 0.5)])
        vtx_t = lbs_numpy(rig.verts, rig.joints, rig.parents, rig.skins, locals_)
        G, q = fk_numpy(rig.joints, rig.parents, locals_)
        rel = pts0[:, None, :] - rig.joints[None, :, :]
        pts_t = np.einsum("jab,pjb->pja", G, rel) + q[None]
        pts_t = np.einsum("pj,pja->pa", pt_skins, pts_t)
        if partial:                          # single view from +z
            ctr = vtx_t.mean(0)
            vert_vis = (vtx_t[:, 2] - ctr[2]) > -0.02
            pt_vis = (pts_t[:, 2] - ctr[2]) > -0.02
        else:
            vert_vis = np.ones(V, bool)
            pt_vis = np.ones(num_points, bool)
        vis[:, t] = vert_vis
        # refill the cloud to P points by repeating its visible points
        keep = np.where(pt_vis)[0]
        sel = keep[rng.integers(0, len(keep), num_points)] if len(keep) else np.zeros(
            num_points, int)
        pts_traj[:, t, :] = pts_t[sel]
        vtx_traj[:, t, :] = vtx_t
        nnv = pt_nn_vert[sel]
        for p_i in range(0, num_points, 4):
            corr_p2v.append([p_i, nnv[p_i], t])
            corr_v2p.append([nnv[p_i], p_i, t])
    return dict(rig=rig, vtx_traj=vtx_traj, pts_traj=pts_traj,
                corr_v2p=np.asarray(corr_v2p, np.int32), corr_p2v=np.asarray(corr_p2v, np.int32),
                vismask=vis, tpl_edges=rig.tpl_edges, geo_edges=rig.geo_edges)


def capsule_batch(B: int, T: int, num_points: int, pad_verts: int, degree: int = 12,
                  n_lat: int = 37, n_lon: int = 36, seed: int = 0):
    """B capsule requests: mesh entries (rest pose = frame 0, padded to
    `pad_verts`, degree-`degree` tables) and their (T, P, 3) keyframe clouds
    (frames 1..T).  Capsule i uses seed `seed + i`."""
    entries, frames = [], []
    for i in range(B):
        seq = make_capsule_sequence(num_frames=T + 1, num_points=num_points, seed=seed + i,
                                    n_lat=n_lat, n_lon=n_lon)
        entries.append(build_mesh(seq["vtx_traj"][:, 0], seq["tpl_edges"], seq["geo_edges"],
                                  pad_verts, degree, degree))
        frames.append(np.transpose(seq["pts_traj"][:, 1:T + 1], (1, 0, 2)))
    return entries, frames
