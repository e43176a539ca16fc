"""Procedural branching-creature fixture (numpy) — counterpart of
morig_tpu/data/creature.py, carried here so the port stands without the
JAX package: for a seed the arrays equal the JAX package's.

Multi-limb bodies of 15-25 joints (a torso chain with head, mirrored arm
and leg chains, an optional tail), meshed from the union-of-capsules SDF by
naive surface nets with the vertex count walked under a target, skinned
analytically, animated by numpy FK/LBS with asymmetric per-limb motion and
a root translation, and seen from +z as partial point clouds with
vertex/point correspondences and per-frame vertex visibility: the dict of
`make_capsule_sequence` (data/synthetic.py); `creature_pose_dataset`,
`creature_rig_dataset` and `creature_skel_dataset` build the pose, rig and
skeleton datasets over them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from morig_tpu_torch.data.synthetic import sample_surface, tpl_edges_from_faces


@dataclasses.dataclass
class Creature:
    verts: np.ndarray          # (V, 3) rest pose
    faces: np.ndarray          # (F, 3)
    tpl_edges: np.ndarray      # (E, 2)
    geo_edges: np.ndarray      # (E2, 2)
    joints: np.ndarray         # (J, 3)
    parents: np.ndarray        # (J,)
    skins: np.ndarray          # (V, J)
    names: List[str]
    bone_radii: np.ndarray     # (J,) radius of bone parent(j)->j (root: body)


# ---------------------------------------------------------------------------
# skeleton
# ---------------------------------------------------------------------------

def make_creature_skeleton(rng: np.random.Generator):
    """Random branching skeleton: torso chain, mirrored arm/leg chains,
    optional tail.  Left/right joints are exact mirrors about x=0 (the
    symmetry assumption of flip/primMST_symmetry, mst_utils.py:294-313)."""
    names: List[str] = []
    pos: List[np.ndarray] = []
    parents: List[int] = []
    radii: List[float] = []

    def add(name, p, parent, r):
        names.append(name)
        pos.append(np.asarray(p, np.float64))
        parents.append(parent)
        radii.append(r)
        return len(names) - 1

    torso_r = rng.uniform(0.085, 0.115)
    limb_r = rng.uniform(0.038, 0.052)
    # torso chain up +y
    pelvis = add("pelvis", [0, 0, 0], -1, torso_r)
    h = 0.0
    h += rng.uniform(0.14, 0.20)
    spine = add("spine", [0, h, 0], pelvis, torso_r)
    h += rng.uniform(0.14, 0.20)
    chest = add("chest", [0, h, 0], spine, torso_r * 0.95)
    h_neck = h + rng.uniform(0.07, 0.11)
    neck = add("neck", [0, h_neck, rng.uniform(0.0, 0.04)], chest, limb_r * 1.2)
    head = add("head", [0, h_neck + rng.uniform(0.09, 0.13), pos[neck][2]],
               neck, rng.uniform(0.07, 0.095))

    # legs from pelvis (mirrored)
    hip_w = torso_r * rng.uniform(0.55, 0.8)
    l_up = rng.uniform(0.16, 0.24)
    l_lo = rng.uniform(0.15, 0.22)
    foot_z = rng.uniform(0.04, 0.09)
    for side, sx in (("L", 1.0), ("R", -1.0)):
        hip = add(f"hip_{side}", [sx * hip_w, -0.02, 0], pelvis, limb_r * 1.15)
        knee = add(f"knee_{side}", [sx * hip_w, -0.02 - l_up, 0], hip, limb_r)
        ankle = add(f"ankle_{side}", [sx * hip_w, -0.02 - l_up - l_lo, 0],
                    knee, limb_r * 0.9)
        add(f"toe_{side}", [sx * hip_w, -0.02 - l_up - l_lo - 0.02, foot_z],
            ankle, limb_r * 0.8)

    # arms from chest (mirrored), angled outward and down
    sh_w = torso_r * rng.uniform(0.95, 1.2)
    a_up = rng.uniform(0.13, 0.19)
    a_lo = rng.uniform(0.12, 0.18)
    a_ang = rng.uniform(0.25, 0.75)       # angle from straight-down, radians
    ca, sa = np.cos(a_ang), np.sin(a_ang)
    for side, sx in (("L", 1.0), ("R", -1.0)):
        sh = add(f"shoulder_{side}", [sx * sh_w, h - 0.01, 0], chest, limb_r * 1.1)
        elb = add(f"elbow_{side}",
                  [sx * (sh_w + a_up * sa), h - 0.01 - a_up * ca, 0], sh, limb_r)
        add(f"wrist_{side}",
            [sx * (sh_w + (a_up + a_lo) * sa), h - 0.01 - (a_up + a_lo) * ca, 0],
            elb, limb_r * 0.85)

    # optional tail off the pelvis, curving back (-z) and down
    n_tail = int(rng.choice([0, 2, 3]))
    prev = pelvis
    tz, ty = -torso_r * 0.8, -0.01
    for k in range(n_tail):
        step = rng.uniform(0.08, 0.13)
        tz -= step
        ty -= step * rng.uniform(0.1, 0.45)
        prev = add(f"tail{k+1}", [0, ty, tz], prev, limb_r * (0.9 - 0.2 * k))

    return (np.asarray(pos, np.float64), np.asarray(parents, np.int32), names,
            np.asarray(radii, np.float64))


# ---------------------------------------------------------------------------
# union-of-capsules SDF + naive surface nets mesher
# ---------------------------------------------------------------------------

def _seg_dist(pts: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance from pts (N,3) to each segment a->b (M,3): (N, M)."""
    ab = b - a                                     # (M, 3)
    denom = np.maximum((ab * ab).sum(-1), 1e-12)   # (M,)
    t = ((pts[:, None, :] - a[None]) * ab[None]).sum(-1) / denom
    t = np.clip(t, 0.0, 1.0)
    proj = a[None] + t[..., None] * ab[None]
    return np.linalg.norm(pts[:, None, :] - proj, axis=-1)


def creature_sdf(pts: np.ndarray, joints: np.ndarray, parents: np.ndarray,
                 radii: np.ndarray) -> np.ndarray:
    """Signed distance of the union of per-bone capsules (negative inside)."""
    child = np.where(parents >= 0)[0]
    a = joints[parents[child]]
    b = joints[child]
    r = radii[child]
    d = _seg_dist(pts, a, b) - r[None]
    return d.min(axis=1)


def surface_nets(sdf: np.ndarray, origin: np.ndarray, spacing: float):
    """Naive surface nets over a scalar grid: one vertex per sign-crossing
    cell (at the mean of its edge crossings), one quad per sign-crossing
    grid edge (shared by the 4 surrounding cells), split into triangles with
    inside->outside winding.  Fully vectorized — meshing 20 creatures must
    not dominate preprocessing."""
    nx, ny, nz = sdf.shape
    corners = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
               (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    cs = [sdf[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz] for dx, dy, dz in corners]
    stack = np.stack(cs)
    active = (stack < 0).any(0) & (stack >= 0).any(0)
    if not active.any():
        raise ValueError("surface_nets: empty surface")
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    cx, cy, cz = active.shape
    base = np.stack(np.meshgrid(np.arange(cx), np.arange(cy), np.arange(cz),
                                indexing="ij"), axis=-1).astype(np.float64)
    acc = np.zeros(active.shape + (3,))
    cnt = np.zeros(active.shape)
    coff = np.asarray(corners, np.float64)
    for e0, e1 in edges:
        s0, s1 = stack[e0], stack[e1]
        cross = (s0 < 0) != (s1 < 0)
        denom = np.where(np.abs(s0 - s1) < 1e-12, 1e-12, s0 - s1)
        t = np.where(cross, s0 / denom, 0.0)
        p = coff[e0][None, None, None] + t[..., None] * (coff[e1] - coff[e0])[None, None, None]
        acc += np.where(cross[..., None], p, 0.0)
        cnt += cross
    vpos = base + acc / np.maximum(cnt, 1.0)[..., None]
    vidx = -np.ones(active.shape, np.int64)
    vidx[active] = np.arange(int(active.sum()))
    verts = (origin[None] + vpos[active] * spacing).astype(np.float32)

    faces = []
    dims = np.array([cx, cy, cz])
    for axis in range(3):
        o1, o2 = (axis + 1) % 3, (axis + 2) % 3
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[axis] = slice(0, -1)
        sl1[axis] = slice(1, None)
        s0, s1 = sdf[tuple(sl0)], sdf[tuple(sl1)]
        cross = (s0 < 0) != (s1 < 0)
        idx = np.argwhere(cross)                       # grid-point coords
        if len(idx) == 0:
            continue
        fl = s0[tuple(idx.T)] < 0                      # inside at the low end
        # bounds: the 4 cells (offsets {0,-1} on o1/o2, same coord on axis)
        ok = (idx[:, axis] < dims[axis]) \
            & (idx[:, o1] >= 1) & (idx[:, o1] < dims[o1] + 1) \
            & (idx[:, o2] >= 1) & (idx[:, o2] < dims[o2] + 1)
        idx, fl = idx[ok], fl[ok]
        quad = np.empty((len(idx), 4), np.int64)
        for qi, (d1, d2) in enumerate(((0, 0), (1, 0), (1, 1), (0, 1))):
            cc = idx.copy()
            cc[:, o1] -= d1
            cc[:, o2] -= d2
            np.clip(cc, 0, dims - 1, out=cc)
            quad[:, qi] = vidx[cc[:, 0], cc[:, 1], cc[:, 2]]
        good = (quad >= 0).all(1)
        quad, fl = quad[good], fl[good]
        quad[fl] = quad[fl][:, ::-1]
        faces.append(np.stack([quad[:, 0], quad[:, 1], quad[:, 2]], 1))
        faces.append(np.stack([quad[:, 0], quad[:, 2], quad[:, 3]], 1))
    return verts, np.concatenate(faces, 0).astype(np.int32)


def mesh_creature(joints, parents, radii, res: int = 44, margin: float = 0.06,
                  target_verts: Optional[int] = None):
    """Mesh the capsule-union SDF; optionally walk the grid resolution down/up
    so the vertex count lands under `target_verts` (V-bucket control)."""
    child = np.where(parents >= 0)[0]
    lo = (joints - radii[:, None]).min(0) - margin
    hi = (joints + radii[:, None]).max(0) + margin
    for _ in range(6):
        spacing = float((hi - lo).max()) / (res - 1)
        ns = np.maximum(((hi - lo) / spacing).astype(int) + 2, 4)
        ax = [lo[d] + np.arange(ns[d]) * spacing for d in range(3)]
        grid = np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)
        sdf = creature_sdf(grid, joints, parents, radii).reshape(tuple(ns))
        verts, faces = surface_nets(sdf, lo, spacing)
        if target_verts is None or len(verts) <= target_verts:
            return verts, faces
        res = int(res * (target_verts / len(verts)) ** (1 / 2.2))
        res = max(res, 16)
    return verts, faces


# ---------------------------------------------------------------------------
# skinning + geodesic-ball edges
# ---------------------------------------------------------------------------

def creature_skins(verts, joints, parents, radii, sharpness: float = 2.5):
    """Per-JOINT weights: joint j influences the region of its outgoing
    bones (segments j->child); leaves influence a sphere at the joint.
    Gaussian falloff in units of the local bone radius, top-4 support,
    normalized — smooth at joints, near-rigid along bone interiors."""
    J = len(joints)
    d = np.full((len(verts), J), np.inf)
    for j in range(J):
        ch = np.where(parents == j)[0]
        if len(ch):
            dj = _seg_dist(verts, np.repeat(joints[j][None], len(ch), 0),
                           joints[ch]).min(1)
            sig = radii[ch].mean()
        else:
            dj = np.linalg.norm(verts - joints[j], axis=1)
            sig = radii[j]
        d[:, j] = dj / max(sig, 1e-6)
    w = np.exp(-sharpness * d ** 2)
    # top-4 support
    k = 4
    thr = np.partition(w, -k, axis=1)[:, -k][:, None]
    w = np.where(w >= thr, w, 0.0)
    # every vertex needs support: fall back to nearest joint region
    empty = w.sum(1) < 1e-12
    if empty.any():
        nn = np.argmin(d[empty], axis=1)
        w[empty, nn] = 1.0
    return (w / w.sum(1, keepdims=True)).astype(np.float32)


def geo_ball_edges(verts: np.ndarray, radius: float = 0.06, max_deg: int = 15):
    """Euclidean-ball neighbor edges capped at max_deg (the geodesic-ball
    edge build of common_ops.py:214-226; euclidean is the honest stand-in
    for synthetic bodies — limbs only touch the torso where they join)."""
    d = np.linalg.norm(verts[:, None] - verts[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    rows, cols = [], []
    order = np.argsort(d, axis=1)[:, :max_deg]
    dist_o = np.take_along_axis(d, order, axis=1)
    for i in range(len(verts)):
        sel = order[i][dist_o[i] < radius]
        rows.append(np.full(len(sel), i))
        cols.append(sel)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    return np.stack([rows, cols], axis=1).astype(np.int64)


# ---------------------------------------------------------------------------
# animation
# ---------------------------------------------------------------------------

def _axis_angle(axis: np.ndarray, ang: float) -> np.ndarray:
    a = axis / max(np.linalg.norm(axis), 1e-9)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)


def make_motion_plan(rng: np.random.Generator, names: List[str]):
    """Per-joint (axis, amplitude, frequency): hinges (knee/elbow) bend about
    x with one sign; ball joints (hip/shoulder/neck/tail) get random axes;
    spine small.  Left/right draws are independent -> asymmetric poses."""
    plan = []
    for n in names:
        base = n.split("_")[0]
        if base in ("knee", "elbow"):
            axis = np.array([1.0, 0, 0]) + 0.1 * rng.normal(size=3)
            amp = rng.uniform(0.35, 1.0) * (1 if base == "knee" else -1)
        elif base in ("hip", "shoulder"):
            axis = rng.normal(size=3)
            amp = rng.uniform(0.25, 0.7)
        elif base in ("neck", "head") or base.startswith("tail"):
            axis = rng.normal(size=3)
            amp = rng.uniform(0.15, 0.45)
        elif base in ("spine", "chest"):
            axis = rng.normal(size=3)
            amp = rng.uniform(0.05, 0.2)
        else:  # pelvis/ankle/toe/wrist: little or no motion
            axis = rng.normal(size=3)
            amp = rng.uniform(0.0, 0.15)
        freq = float(rng.choice([0.5, 1.0, 1.5]))
        phase_dir = 1.0 if rng.random() < 0.5 else -1.0
        plan.append((axis, amp * phase_dir, freq))
    return plan


def creature_local_rots(plan, t: int, T: int) -> np.ndarray:
    """Local rotations at frame t; frame 0 is the rest pose."""
    s = t / max(T - 1, 1)
    out = []
    for axis, amp, freq in plan:
        ang = amp * np.sin(freq * np.pi * s)
        out.append(_axis_angle(axis, ang))
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# single-view visibility (z-buffer from +z)
# ---------------------------------------------------------------------------

def zbuffer_visibility(query: np.ndarray, occluders: np.ndarray,
                       grid: int = 72, eps: float = 0.025) -> np.ndarray:
    """Visible-from-+z test: bin occluders into an (x, y) grid, keep query
    points within eps of the per-cell max depth.  Approximates the partial
    single-view capture of the reference's depth-sequence data."""
    lo = occluders[:, :2].min(0)
    hi = occluders[:, :2].max(0)
    span = np.maximum(hi - lo, 1e-6)

    def cell(p):
        c = np.floor((p[:, :2] - lo) / span * (grid - 1e-6)).astype(int)
        return np.clip(c, 0, grid - 1)

    zmax = np.full((grid, grid), -np.inf)
    co = cell(occluders)
    np.maximum.at(zmax, (co[:, 0], co[:, 1]), occluders[:, 2])
    cq = cell(query)
    return query[:, 2] >= zmax[cq[:, 0], cq[:, 1]] - eps


# ---------------------------------------------------------------------------
# full sequence generator
# ---------------------------------------------------------------------------

def make_creature(seed: int = 0, target_verts: int = 1900, res: int = 44) -> Creature:
    rng = np.random.default_rng(seed)
    joints, parents, names, radii = make_creature_skeleton(rng)
    verts, faces = mesh_creature(joints, parents, radii, res=res,
                                 target_verts=target_verts)
    skins = creature_skins(verts, joints, parents, radii)
    return Creature(
        verts=verts, faces=faces,
        tpl_edges=tpl_edges_from_faces(faces),
        geo_edges=geo_ball_edges(verts),
        joints=joints.astype(np.float32), parents=parents,
        skins=skins, names=names, bone_radii=radii,
    )


def make_creature_sequence(
    seed: int = 0,
    num_frames: int = 21,
    num_points: int = 1024,
    partial: bool = True,
    target_verts: int = 1900,
    res: int = 44,
    motion_seed: Optional[int] = None,
    root_motion: bool = True,
):
    """Animated creature with point clouds, correspondences, visibility —
    the same dict contract as make_capsule_sequence (data/synthetic.py) so
    every dataset/pipeline hook works unchanged."""
    from morig_tpu_torch.data.synthetic import fk_numpy, lbs_numpy

    rng = np.random.default_rng(seed if motion_seed is None else motion_seed)
    c = make_creature(seed, target_verts=target_verts, res=res)
    V, T = len(c.verts), num_frames
    plan = make_motion_plan(rng, c.names)
    r_amp = rng.uniform(0.0, 0.05, size=3) if root_motion else np.zeros(3)
    r_freq = float(rng.choice([0.5, 1.0]))

    pts0, fid, bary = sample_surface(c.verts, c.faces, num_points, rng)
    pt_skins = (c.skins[c.faces[fid]] * bary[..., None]).sum(axis=1)
    pt_nn_vert = c.faces[fid, np.argmax(bary, axis=1)]

    vtx_traj = np.zeros((V, T, 3), np.float32)
    pts_traj = np.zeros((num_points, T, 3), np.float32)
    vis = np.zeros((V, T), np.float32)
    corr_v2p, corr_p2v = [], []
    for t in range(T):
        locals_ = creature_local_rots(plan, t, T)
        rt = r_amp * np.sin(r_freq * np.pi * t / max(T - 1, 1))
        vtx_t = lbs_numpy(c.verts, c.joints, c.parents, c.skins, locals_, rt)
        G, q = fk_numpy(c.joints, c.parents, locals_, rt)
        rel = pts0[:, None, :] - c.joints[None, :, :]
        pts_t = np.einsum("jab,pjb->pja", G, rel) + q[None]
        pts_t = np.einsum("pj,pja->pa", pt_skins, pts_t)

        if partial:
            occl = np.concatenate([vtx_t, pts_t], 0)
            vert_vis = zbuffer_visibility(vtx_t, occl)
            pt_vis = zbuffer_visibility(pts_t, occl)
        else:
            vert_vis = np.ones(V, bool)
            pt_vis = np.ones(num_points, bool)
        vis[:, t] = vert_vis

        keep = np.where(pt_vis)[0]
        sel = keep[rng.integers(0, len(keep), num_points)] if len(keep) \
            else np.zeros(num_points, int)
        pts_traj[:, t, :] = pts_t[sel]
        vtx_traj[:, t, :] = vtx_t

        nnv = pt_nn_vert[sel]
        for p_i in range(0, num_points, 4):
            corr_p2v.append([p_i, nnv[p_i], t])
            corr_v2p.append([nnv[p_i], p_i, t])

    return dict(
        rig=c,
        vtx_traj=vtx_traj,
        pts_traj=pts_traj,
        corr_v2p=np.asarray(corr_v2p, np.int32),
        corr_p2v=np.asarray(corr_p2v, np.int32),
        vismask=vis,
        tpl_edges=c.tpl_edges,
        geo_edges=c.geo_edges,
    )


# ---------------------------------------------------------------------------
# dataset constructors (mirroring the capsule_* helpers)
# ---------------------------------------------------------------------------

def creature_pose_dataset(num_models: int = 8, seed: int = 0, num_frames: int = 6,
                          num_points: int = 1024, target_verts: int = 1900,
                          **kw):
    from morig_tpu_torch.data.pose import PoseDataset, PoseModel

    models = []
    for i in range(num_models):
        seq = make_creature_sequence(seed=seed + i, num_frames=num_frames,
                                     num_points=num_points,
                                     target_verts=target_verts, **kw)
        models.append(PoseModel(
            name=f"creature{seed + i}",
            vtx_traj=seq["vtx_traj"], pts_traj=seq["pts_traj"],
            corr_v2p=seq["corr_v2p"], corr_p2v=seq["corr_p2v"],
            vismask=seq["vismask"], tpl_edges=seq["tpl_edges"],
            geo_edges=seq["geo_edges"],
        ))
    return PoseDataset(models)


def creature_rig_dataset(num_models: int = 8, seed: int = 0, num_keyframes: int = 5,
                         noise: float = 0.01, num_points: int = 1024,
                         target_verts: int = 1900, use_volumetric_geo: bool = False,
                         pred_flows: Optional[list] = None, device="cuda", **kw):
    """RigDataset over creatures.  pred_flow is gt_flow plus seeded noise
    unless `pred_flows` (one (V, 3T) array per model, e.g. a trained
    DeformNet's) is given.  The skin descriptors take the euclidean
    vertex-to-bone distance, or with `use_volumetric_geo` the volumetric
    geodesic (`geometry.geodesic.vertex_bone_geodesic`, its line of sight
    on `device`)."""
    from morig_tpu_torch.data.rig import RigDataset, build_rig_model
    from morig_tpu_torch.geometry import skeleton as sk

    rng = np.random.default_rng(seed + 991)
    models = []
    for i in range(num_models):
        seq = make_creature_sequence(seed=seed + i, num_frames=num_keyframes + 1,
                                     num_points=num_points, target_verts=target_verts, **kw)
        c = seq["rig"]
        rig = sk.Rig(names=list(c.names), pos=c.joints.astype(np.float64),
                     parents=c.parents, skins=c.skins)
        keyframes = list(range(1, num_keyframes + 1))
        gt_flow = np.concatenate(
            [seq["vtx_traj"][:, t, :] - seq["vtx_traj"][:, 0, :] for t in keyframes], 1)
        if pred_flows is not None:
            pred = pred_flows[i]
        else:
            pred = (gt_flow + noise * rng.normal(size=gt_flow.shape)).astype(np.float32)
        geo_dist = None
        if use_volumetric_geo:
            from morig_tpu_torch.geometry.geodesic import vertex_bone_geodesic
            from morig_tpu_torch.geometry.voxel import voxelize_mesh

            rest = seq["vtx_traj"][:, 0, :]
            bones, _, _ = sk.get_bones(rig)
            geo_dist = vertex_bone_geodesic(rest, bones, voxelize_mesh(rest, c.faces),
                                            faces=c.faces, device=device)
        models.append(build_rig_model(
            f"creature{seed + i}", seq["vtx_traj"][:, 0, :], seq["tpl_edges"],
            seq["geo_edges"], rig, seq["vtx_traj"], keyframes, pred_flow=pred,
            geo_dist=geo_dist))
    return RigDataset(models)


def creature_skel_dataset(num_models: int = 8, seed: int = 0, max_joints: int = 32,
                          perturb: float = 0.02, extra_per_model: int = 2,
                          target_verts: int = 1900, device="cuda", **kw):
    """One SkelSample for Bone/Root training on `device`: per creature
    (`make_creature`, `kw` going to it) the GT joint set plus
    `extra_per_model` copies jittered by perturb * N(0, 1) (the kind of joint
    sets a trained JointNet emits), each a row of its own, the mesh padded
    to its 1024/2048/4096 bucket."""
    from morig_tpu_torch.core import batch as B
    from morig_tpu_torch.data.skeleton_data import build_skel_sample
    from morig_tpu_torch.geometry import skeleton as sk

    rng = np.random.default_rng(seed + 4242)
    entries, joints_list, rigs = [], [], []
    for i in range(num_models):
        c = make_creature(seed + i, target_verts=target_verts, **kw)
        rig = sk.Rig(names=list(c.names), pos=c.joints.astype(np.float64),
                     parents=c.parents, skins=c.skins)
        entry = B.build_mesh(c.verts, c.tpl_edges, c.geo_edges,
                             B.bucket_size(len(c.verts), (1024, 2048, 4096)))
        for k in range(1 + extra_per_model):
            jit = 0.0 if k == 0 else perturb * rng.normal(size=c.joints.shape)
            entries.append(entry)
            joints_list.append(c.joints + jit)
            rigs.append(rig)
    return build_skel_sample(entries, joints_list, rigs, max_joints=max_joints, device=device)
