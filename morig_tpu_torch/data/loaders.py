"""Loaders for the reference's preprocessed on-disk dataset layout — a copy
of morig_tpu/data/loaders.py (numpy) that builds the port's `PoseModel` and
`RigModel`.

Users of the reference point these at the same folders its datasets consume
(datasets/dataset_pose.py:48-98, dataset_rig.py:78-140): per model
  {name}_vtx_traj.npy   (V, T, 3) or (V, 3T) vertex trajectories
  {name}_pts_traj.npy   (P, 3T)   point-cloud trajectories
  {name}_corr_v2p.npy / _corr_p2v.npy   (N, 3) [idx, idx, frame]
  {name}_vismask.npy    (V, T)
  {name}_tpl_e.txt / _geo_e.txt         edge lists
and for the rig stage additionally
  {name}_rig.txt  {name}_attn.txt  {name}_skin.txt  pred_flow/{name}_{t}_pred_flow.npy

Keyframe selection mirrors the reference datasets: modelsresource keyframes
0,20..100 with corr frame ids divided by 20; deformingthings 0,19..95 (/19);
sequential variants keep frames 0..20 untouched.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from morig_tpu_torch.data.mesh_io import load_edge_file, read_obj
from morig_tpu_torch.data.pose import PoseModel
from morig_tpu_torch.data.rig import RigModel, build_rig_model
from morig_tpu_torch.geometry import skeleton as sk


def _keyframes(kind: str, sequential: bool) -> tuple[np.ndarray, int]:
    if sequential:
        return np.arange(0, 21), 1
    if kind == "modelsresource":
        return np.arange(0, 110, 20), 20
    if kind == "deformingthings":
        return np.arange(0, 100, 19), 19
    raise ValueError(kind)


def load_pose_model(prefix: str, kind: str = "modelsresource",
                    sequential: bool = False) -> PoseModel:
    """Load one model given the path prefix (folder/name)."""
    name = os.path.basename(prefix)
    vtx = np.load(prefix + "_vtx_traj.npy")
    pts = np.load(prefix + "_pts_traj.npy")
    if vtx.ndim == 2:
        vtx = vtx.reshape(len(vtx), -1, 3)
    if pts.ndim == 2:
        pts = pts.reshape(len(pts), -1, 3)
    corr_v2p = np.load(prefix + "_corr_v2p.npy").astype(np.int64)
    corr_p2v = np.load(prefix + "_corr_p2v.npy").astype(np.int64)
    vis = np.load(prefix + "_vismask.npy")
    tpl = load_edge_file(prefix + "_tpl_e.txt")
    geo = load_edge_file(prefix + "_geo_e.txt")

    frames, divisor = _keyframes(kind, sequential)
    frames = frames[frames < vtx.shape[1]]
    sel_v2p = corr_v2p[np.isin(corr_v2p[:, -1], frames)].copy()
    sel_p2v = corr_p2v[np.isin(corr_p2v[:, -1], frames)].copy()
    sel_v2p[:, -1] = sel_v2p[:, -1] // divisor
    sel_p2v[:, -1] = sel_p2v[:, -1] // divisor
    return PoseModel(
        name=name,
        vtx_traj=vtx[:, frames, :].astype(np.float32),
        pts_traj=pts[:, frames, :].astype(np.float32),
        corr_v2p=sel_v2p.astype(np.int32),
        corr_p2v=sel_p2v.astype(np.int32),
        vismask=vis[:, frames].astype(np.float32),
        tpl_edges=tpl, geo_edges=geo,
    )


def load_pose_models(folder: str, kind: str = "modelsresource",
                     sequential: bool = False, limit: Optional[int] = None) -> List[PoseModel]:
    prefixes = sorted(
        f[: -len("_vtx_traj.npy")] for f in glob.glob(os.path.join(folder, "*_vtx_traj.npy"))
    )
    if limit:
        prefixes = prefixes[:limit]
    return [load_pose_model(p, kind, sequential) for p in prefixes]


def parse_skin_file(path: str, num_nearest_bone: int = 20):
    """Parse the reference's *_skin.txt, written by gen_skin_data.py:119-136:
    'bones <pname> <cname> <6 floats>' rows, then per-vertex
    'bind <vid> (<bone_id> <1/dist> <isleaf>)*K' rows, then per-vertex
    'influence <K floats>' soft-label rows.

    Semantics pinned to dataset_rig.py:31-76 (load_skin): slot i reads
    words[3i+1 .. 3i+3] (the leading field is the vertex id); a -1 bone id
    marks a missing slot, which repeats slot 0's bone/1-dist/isleaf with
    loss_mask 0.

    Returns (skin_input (V,K*8), skin_nn (V,K), skin_label (V,K),
    loss_mask (V,K), bone_names)."""
    bones: List[List[float]] = []
    bone_names: List[tuple] = []
    inputs, nn_ids, masks, labels = [], [], [], []
    with open(path) as f:
        for line in f:
            w = line.strip().split()
            if not w:
                continue
            if w[0] == "bones":
                bone_names.append((w[1], w[2]))
                bones.append([float(x) for x in w[3:]])
            elif w[0] == "bind":
                vals = [float(x) for x in w[1:]]   # [vid, (bid, invd, leaf)*K]
                row, ids, mask = [], [], []
                for i in range(num_nearest_bone):
                    bid = int(vals[3 * i + 1])
                    if bid == -1:           # missing slot: repeat slot 0
                        bid0 = max(int(vals[1]), 0)  # guard a fully-empty row
                        row += bones[bid0] + [vals[2], vals[3]]
                        ids.append(bid0)
                        mask.append(0)
                    else:
                        row += bones[bid] + [vals[3 * i + 2], vals[3 * i + 3]]
                        ids.append(bid)
                        mask.append(1)
                inputs.append(row)
                nn_ids.append(ids)
                masks.append(mask)
            elif w[0] == "influence":
                labels.append([float(x) for x in w[1:]])
    return (np.asarray(inputs, np.float32), np.asarray(nn_ids, np.int32),
            np.asarray(labels, np.float32), np.asarray(masks, np.int32), bone_names)


def load_rig_model(prefix: str, num_keyframes: int = 5,
                   keyframe_step: int = 20) -> RigModel:
    """Load one rig-stage model from the reference layout (dataset_rig.py)."""
    name = os.path.basename(prefix)
    folder = os.path.dirname(prefix)
    vtx = np.load(prefix + "_vtx_traj.npy")
    if vtx.ndim == 2:
        vtx = vtx.reshape(len(vtx), -1, 3)
    tpl = load_edge_file(prefix + "_tpl_e.txt")
    geo = load_edge_file(prefix + "_geo_e.txt")
    rig = sk.Rig.load(prefix + "_rig.txt")
    attn = np.loadtxt(prefix + "_attn.txt")

    keyframes = [t * keyframe_step for t in range(1, num_keyframes + 1)]
    keyframes = [min(t, vtx.shape[1] - 1) for t in keyframes]
    pred_flow = None
    pf_dir = os.path.join(folder, "pred_flow")
    if os.path.isdir(pf_dir):
        parts = []
        for t in range(1, num_keyframes + 1):
            p = os.path.join(pf_dir, f"{name}_{t}_pred_flow.npy")
            if os.path.exists(p):
                parts.append(np.load(p))
        if len(parts) == num_keyframes:
            pred_flow = np.concatenate(parts, axis=1).astype(np.float32)

    skin_path = prefix + "_skin.txt"
    model = build_rig_model(
        name, vtx[:, 0, :].astype(np.float32), tpl, geo, rig, vtx, keyframes,
        pred_flow=pred_flow,
    )
    if os.path.exists(skin_path):
        s_in, s_nn, s_lab, s_mask, _ = parse_skin_file(skin_path)
        model.skin_input, model.skin_nn = s_in, s_nn
        model.skin_label, model.loss_mask = s_lab, s_mask
    model.attn = np.asarray(attn, np.float32).reshape(-1)
    return model


def load_rig_models(folder: str, limit: Optional[int] = None, **kw) -> List[RigModel]:
    prefixes = sorted(
        f[: -len("_rig.txt")] for f in glob.glob(os.path.join(folder, "*_rig.txt"))
    )
    if limit:
        prefixes = prefixes[:limit]
    return [load_rig_model(p, **kw) for p in prefixes]


def load_shape_model(prefix: str) -> PoseModel:
    """Load one shape-difference model (datasets/dataset_shape.py:32-82
    layout: {name}_0.obj rest mesh + _pts/_flow/_corr_*/_vismask, single
    deformation pair).  Mapped onto the 2-frame PoseModel convention: frame 0
    is the rest mesh, frame 1 the flow-deformed target."""
    name = os.path.basename(prefix)
    verts, _ = read_obj(prefix + "_0.obj")
    pts = np.load(prefix + "_pts.npy").astype(np.float32)
    flow = np.load(prefix + "_flow.npy").astype(np.float32)
    corr_v2p = np.load(prefix + "_corr_v2p.npy").astype(np.int64)
    corr_p2v = np.load(prefix + "_corr_p2v.npy").astype(np.int64)
    vis = np.load(prefix + "_vismask.npy").astype(np.float32).reshape(len(verts))
    tpl = load_edge_file(prefix + "_tpl_e.txt")
    geo = load_edge_file(prefix + "_geo_e.txt")

    def with_frame(c):
        if c.shape[1] == 2:
            c = np.concatenate([c, np.ones((len(c), 1), c.dtype)], axis=1)
        else:
            c = c.copy()
            c[:, -1] = 1
        return c.astype(np.int32)

    vtx_traj = np.stack([verts, verts + flow], axis=1)
    pts_traj = np.stack([pts, pts], axis=1)
    return PoseModel(
        name=name, vtx_traj=vtx_traj.astype(np.float32),
        pts_traj=pts_traj.astype(np.float32),
        corr_v2p=with_frame(corr_v2p), corr_p2v=with_frame(corr_p2v),
        vismask=np.stack([vis, vis], axis=1), tpl_edges=tpl, geo_edges=geo,
    )


def load_shape_models(folder: str, limit: Optional[int] = None) -> List[PoseModel]:
    prefixes = sorted(
        f[: -len("_0.obj")] for f in glob.glob(os.path.join(folder, "*_0.obj"))
    )
    if limit:
        prefixes = prefixes[:limit]
    return [load_shape_model(p) for p in prefixes]
