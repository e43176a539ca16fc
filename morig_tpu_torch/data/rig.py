"""Rig dataset: padded RigSample batches for joint, mask and skin training —
counterpart of morig_tpu/data/rig.py.  Per model: the rest-pose mesh, GT
joints, vertex-to-nearest-joint offsets, the GT attention mask, the padded
skin matrix, the keyframe GT flows, the deform stage's predicted flows and
the K-nearest-bone skin descriptors and labels, built on the host in numpy
and moved to the device by `RigDataset.batch`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from morig_tpu_torch.core import batch as B
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.bones import pack_skin_descriptors
from morig_tpu_torch.nn.gcu import windowed_tile


@dataclasses.dataclass
class RigModel:
    name: str
    verts: np.ndarray           # (V, 3) rest pose
    tpl_edges: np.ndarray
    geo_edges: np.ndarray
    rig: sk.Rig                 # GT rig with skins (V, J)
    gt_flow: np.ndarray         # (V, 3*T)
    pred_flow: np.ndarray       # (V, 3*T)
    attn: np.ndarray            # (V,) GT attention mask
    skin_input: np.ndarray      # (V, K*8)
    skin_label: np.ndarray      # (V, K)
    skin_nn: np.ndarray         # (V, K)
    loss_mask: np.ndarray       # (V, K)


def bone_influences(rig: sk.Rig) -> np.ndarray:
    """Per-bone GT influence from the joint skins: a bone inherits its parent
    joint's skin weights; where several bones share a parent the first takes
    them (bind to the parent)."""
    bones, names, _ = sk.get_bones(rig)
    out = np.zeros((rig.skins.shape[0], len(bones)))
    seen = set()
    idx = {n: i for i, n in enumerate(rig.names)}
    for b, (pname, _) in enumerate(names):
        if pname not in seen:
            out[:, b] = rig.skins[:, idx[pname]]
            seen.add(pname)
    return out


def _fma(x, y, z):
    """float32 x * y + z with one rounding (the float64 product of two float32
    values is exact)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _dot3(x, y):
    return _fma(x[..., 2], y[..., 2], _fma(x[..., 1], y[..., 1], x[..., 0] * y[..., 0]))


def euclidean_bone_dist(verts: np.ndarray, bones: np.ndarray) -> np.ndarray:
    """(V, 3), (M, 6) -> (V, M) float32 vertex-to-segment distances on the
    host: `geometry.bones.point_to_segment_dist` in float32 numpy with its
    multiply-adds fused, as the JAX package's compiled CPU program runs them,
    so that the skin descriptors (and the order of the nearest bones) equal
    the JAX package's bit for bit."""
    pts, bones = np.asarray(verts, np.float32), np.asarray(bones, np.float32)
    a, ab = bones[:, :3], bones[:, 3:] - bones[:, :3]
    l2 = _dot3(ab, ab)[None]
    t = _dot3(pts[:, None, :] - a[None], ab[None]) / np.maximum(l2, np.float32(1e-8))
    t = np.where(l2 < 1e-8, np.float32(0.0), np.clip(t, 0.0, 1.0)).astype(np.float32)
    d = pts[:, None, :] - _fma(t[..., None], ab[None], a[None])
    return np.sqrt(_dot3(d, d))


def build_rig_model(name: str, verts: np.ndarray, tpl_edges: np.ndarray,
                    geo_edges: np.ndarray, rig: sk.Rig, vtx_traj: np.ndarray,
                    keyframes: Sequence[int], pred_flow: Optional[np.ndarray] = None,
                    num_nearest_bone: int = 20, geo_dist: Optional[np.ndarray] = None,
                    attn_radius: float = 0.08) -> RigModel:
    """Assemble one rig-training model from its rest mesh, rig and vertex
    trajectory (V, T_all, 3).  `geo_dist` (V, bones) is a vertex-to-bone
    distance; the euclidean point-to-segment distance when None."""
    flows = [vtx_traj[:, t, :] - vtx_traj[:, 0, :] for t in keyframes]
    gt_flow = np.concatenate(flows, axis=1).astype(np.float32)
    if pred_flow is None:
        pred_flow = gt_flow
    bones, _, isleaf = sk.get_bones(rig)
    if geo_dist is None:
        geo_dist = euclidean_bone_dist(verts, bones)
    desc, nn, mask = pack_skin_descriptors(geo_dist, bones, isleaf, num_nearest_bone)
    skin_label = np.take_along_axis(bone_influences(rig), nn, axis=1).astype(np.float32)
    # GT attention: the vertices within attn_radius of a joint
    dj = np.linalg.norm(verts[:, None] - rig.pos[None], axis=-1).min(1)
    attn = (dj < attn_radius).astype(np.float32)
    return RigModel(name=name, verts=verts.astype(np.float32), tpl_edges=tpl_edges,
                    geo_edges=geo_edges, rig=rig, gt_flow=gt_flow,
                    pred_flow=pred_flow.astype(np.float32), attn=attn, skin_input=desc,
                    skin_label=skin_label, skin_nn=nn, loss_mask=mask)


class RigDataset:
    """RigModels padded to one vertex bucket, with their mesh tables built
    once.  `edge_tile` as PoseDataset's: a batch whose tables are all local
    at it runs its edge layers on the windowed K5."""

    def __init__(self, models: Sequence[RigModel], pad_verts: Optional[int] = None,
                 max_joints: int = 48, nearest_bone: int = 5, tpl_max_degree: int = 16,
                 geo_max_degree: int = 16, edge_tile: Optional[int] = None):
        self.models = list(models)
        self.edge_tile = edge_tile
        if pad_verts is None:
            top = max(len(m.verts) for m in self.models)
            pad_verts = B.bucket_size(top, (256, 512, 1024, 2048, 4096, 8192))
        self.pad_verts = pad_verts
        self.max_joints = max_joints
        self.nearest_bone = nearest_bone
        self._mesh_cache = [B.build_mesh(m.verts, m.tpl_edges, m.geo_edges, pad_verts,
                                         tpl_max_degree, geo_max_degree)
                            for m in self.models]

    def __len__(self):
        return len(self.models)

    def batch(self, indices: Sequence[int], device="cuda") -> B.RigSample:
        """The models at `indices` as one RigSample on `device` (the card
        unless the caller asks for another)."""
        P, K = self.pad_verts, self.nearest_bone
        cols = {k: [] for k in ("joints", "joints_mask", "offsets", "attn", "gt_skin", "gt_flow",
                                "pred_flow", "skin_input", "skin_label", "skin_nn",
                                "loss_mask")}
        for i in indices:
            m = self.models[i]
            J = m.rig.num_joints
            jm = np.zeros(self.max_joints, bool)
            jm[:J] = True
            nearest = np.argmin(np.linalg.norm(m.verts[:, None] - m.rig.pos[None], axis=-1),
                                axis=1)
            skin = np.zeros((len(m.verts), self.max_joints), np.float32)
            skin[:, :J] = m.rig.skins
            desc = m.skin_input[:, :8 * K] if K * 8 <= m.skin_input.shape[1] else m.skin_input
            cols["joints"].append(B.pad_to(m.rig.pos.astype(np.float32), self.max_joints))
            cols["joints_mask"].append(jm)
            cols["offsets"].append(B.pad_to((m.rig.pos[nearest] - m.verts).astype(np.float32), P))
            cols["attn"].append(B.pad_to(m.attn, P))
            cols["gt_skin"].append(B.pad_to(skin, P))
            cols["gt_flow"].append(B.pad_to(m.gt_flow, P))
            cols["pred_flow"].append(B.pad_to(m.pred_flow, P))
            cols["skin_input"].append(B.pad_to(desc, P))
            cols["skin_label"].append(B.pad_to(m.skin_label[:, :K], P))
            cols["skin_nn"].append(B.pad_to(m.skin_nn[:, :K], P))
            cols["loss_mask"].append(B.pad_to(m.loss_mask[:, :K], P))
        dtypes = {"joints_mask": torch.bool, "skin_nn": torch.int64, "loss_mask": torch.int32}
        arr = {k: torch.as_tensor(np.stack(v), dtype=dtypes.get(k, torch.float32), device=device)
               for k, v in cols.items()}
        entries = [self._mesh_cache[i] for i in indices]
        mesh = B.stack_meshes(entries, device=device,
                              edge_tile=windowed_tile(entries, self.edge_tile))
        return B.RigSample(mesh=mesh, joints=arr["joints"], joints_mask=arr["joints_mask"],
                           offsets=arr["offsets"], attn_mask=arr["attn"], gt_skin=arr["gt_skin"],
                           gt_flow=arr["gt_flow"], pred_flow=arr["pred_flow"],
                           skin_input=arr["skin_input"], skin_label=arr["skin_label"],
                           skin_nn=arr["skin_nn"], loss_mask=arr["loss_mask"])

    def epoch_schedule(self, rng: np.random.Generator, batch_size: int,
                       train: bool = True) -> list[list[int]]:
        """Model indices of one epoch's batches: a permutation in training
        (the ragged tail filled from its start), in order otherwise (the tail
        filled with its last model)."""
        order = rng.permutation(len(self.models)) if train else np.arange(len(self.models))
        sched = []
        for s in range(0, len(order), batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, order[:batch_size - len(idx)]]) if train \
                    else np.concatenate([idx, np.repeat(idx[-1:], batch_size - len(idx))])
            sched.append([int(i) for i in idx])
        return sched

    def epoch_batches(self, rng: np.random.Generator, batch_size: int, train: bool = True,
                      device="cuda"):
        for idx in self.epoch_schedule(rng, batch_size, train):
            yield self.batch(idx, device)


def capsule_rig_dataset(num_models: int = 2, seed: int = 0, num_keyframes: int = 5,
                        noise: float = 0.01, **kw) -> RigDataset:
    """RigDataset over synthetic capsules; pred_flow is gt_flow plus seeded
    noise, standing in for a deform stage's dumps."""
    from morig_tpu_torch.data.synthetic import make_capsule_sequence

    rng = np.random.default_rng(seed)
    models = []
    for i in range(num_models):
        seq = make_capsule_sequence(num_frames=num_keyframes + 1, seed=seed + i, **kw)
        cap = seq["rig"]
        rig = sk.Rig(names=list(cap.names), pos=cap.joints.astype(float),
                     parents=cap.parents, skins=cap.skins)
        keyframes = list(range(1, num_keyframes + 1))
        gt_flow = np.concatenate(
            [seq["vtx_traj"][:, t, :] - seq["vtx_traj"][:, 0, :] for t in keyframes], 1)
        pred = gt_flow + noise * rng.normal(size=gt_flow.shape)
        models.append(build_rig_model(
            f"capsule{i}", seq["vtx_traj"][:, 0, :], seq["tpl_edges"], seq["geo_edges"],
            rig, seq["vtx_traj"], keyframes, pred_flow=pred.astype(np.float32)))
    return RigDataset(models)
