"""Tracking: per-frame DeformNet flow and two-stage IK against a
point-cloud stream — counterpart of morig_tpu/pipelines/tracking.py.

Each frame: DeformNet's flow from the current vertices to the frame's
cloud; IK stage 1 drags the rest-pose rig toward the flow-moved vertices
(visible ones weighted); the correspondence gate binds each point to its
most similar vertex (kept when similarity, distance and visibility pass);
IK stage 2 refines against the raw points.  `Tracker.step` / `run` take
and return host arrays per frame; `make_scanned_tracker` and
`BatchedTracker.make_scanned` keep the state on the device across the
frame loop (the port's form of the JAX `lax.scan`) and return the same
host arrays in the same layouts.  The IK and the gate run at full fp32
matmul precision (no TF32).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from morig_tpu_torch.core.batch import PointBatch, stack_meshes
from morig_tpu_torch.core.config import TrackingConfig
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.fk import FKTopology, fk, fk_masked, lbs_blend, topology_arrays
from morig_tpu_torch.geometry.ik import (IKConfig, highest_precision, make_ik_solver,
                                         make_ik_solver_masked)
from morig_tpu_torch.geometry.rotations import matrix_to_quaternion
from morig_tpu_torch.nn.deformnet import DeformNet
from morig_tpu_torch.pipelines.rig_predict import StageTimer


@dataclasses.dataclass
class TrackState:
    verts: np.ndarray            # current vertex positions (V, 3)
    quats: Optional[np.ndarray]  # last frame's per-joint quaternions (J, 4)
    vismask: Optional[np.ndarray]


def _ik_configs(cfg: TrackingConfig) -> tuple[IKConfig, IKConfig]:
    return tuple(IKConfig(iters=iters, lr=lr, weight_decay=cfg.ik_weight_decay,
                          vismask_threshold=cfg.vismask_threshold, w_invis=0.0)
                 for iters, lr in ((cfg.ik_iters_stage1, cfg.ik_lr_stage1),
                                   (cfg.ik_iters_stage2, cfg.ik_lr_stage2)))


def _gate(cfg: TrackingConfig, sim, posed, pts, vismask):
    """Correspondence gate over sim (..., Vv, P): each point's most similar
    vertex (the first on ties) and a 0/1 weight from the similarity, the
    squared distance to that posed vertex and its visibility."""
    best_sim, best_v = sim.max(-2)
    l2 = ((torch.take_along_dim(posed, best_v[..., None], dim=-2) - pts) ** 2).sum(-1)
    keep = (best_sim > cfg.corr_sim_threshold) & (l2 < cfg.corr_l2_threshold)
    vis = torch.take_along_dim(vismask, best_v, dim=-1) > cfg.vismask_threshold
    return best_v, keep.float() * vis


class Tracker:
    """Track one rigged mesh against a point-cloud sequence with `deform`,
    on its device."""

    def __init__(self, deform: DeformNet, rig: sk.Rig, mesh_entry: dict,
                 cfg: TrackingConfig = TrackingConfig()):
        assert rig.skins is not None
        self.deform, self.rig, self.cfg, self.mesh_entry = deform, rig, cfg, mesh_entry
        dev = self.device = next(deform.parameters()).device
        self.topo = FKTopology(rig.parents)
        self.offsets = torch.as_tensor(rig.offsets(), dtype=torch.float32, device=dev)
        self.eye = torch.eye(3, device=dev).repeat(rig.num_joints, 1, 1)
        with highest_precision():
            self.G0, self.q0 = fk(self.topo, self.eye, self.offsets)
        self.skins = torch.as_tensor(rig.skins, dtype=torch.float32, device=dev)
        self.mesh = stack_meshes([mesh_entry], dev)
        self.num_valid = nv = int(np.asarray(mesh_entry["vert_mask"]).sum())
        self.rest_v = self.mesh.verts[0, :nv]           # the stage-1 reference pose
        self.arange_v = torch.arange(nv, device=dev)
        ik1, ik2 = _ik_configs(cfg)
        self.solver1 = make_ik_solver(self.topo, ik1)
        self.solver2 = make_ik_solver(self.topo, ik2)

    @torch.no_grad()
    def _flow(self, verts: torch.Tensor, pts: torch.Tensor):
        """DeformNet on the mesh at `verts` (nv, 3) (zero-padded) and the
        cloud pts (P, 3): (pred_flow (V,3), vtx_f (V,C), pts_f (P,C), vis (V,))."""
        pad = self.mesh.verts.shape[1] - verts.shape[0]
        verts_p = torch.cat([verts, verts.new_zeros(pad, 3)])[None]
        mesh = dataclasses.replace(self.mesh, verts=verts_p)
        points = PointBatch(pts[None], torch.ones((1, pts.shape[0]), dtype=torch.bool,
                                                  device=pts.device))
        pred_flow, vtx_f, pts_f, vis, _ = self.deform(mesh, points)
        return pred_flow[0], vtx_f[0], pts_f[0], vis[0]

    def _corr_filter(self, vtx_f, pts_f, posed, pts, vismask):
        nv = self.num_valid
        return _gate(self.cfg, vtx_f[:nv] @ pts_f.T, posed, pts, vismask)

    def _frame(self, verts: torch.Tensor, pts: torch.Tensor, timer: StageTimer):
        """One frame on the device: (posed (nv,3), vismask (nv,), quats (J,4))."""
        nv = self.num_valid
        pred_flow, vtx_f, pts_f, vis = self._flow(verts, pts)
        timer.mark("flow")
        vis_v = vis[:nv]
        with highest_precision():
            locals1, G1, q1 = self.solver1(self.eye, self.offsets, self.G0, self.q0,
                                           self.rest_v, self.skins, self.arange_v,
                                           verts + pred_flow[:nv], vis_v)
            posed1 = lbs_blend(G1, q1, self.G0, self.q0, self.rest_v, self.skins)
            timer.mark("ik1")
            best_v, w = self._corr_filter(vtx_f, pts_f, posed1, pts, vis_v)
            timer.mark("gate")
            locals2, G2, q2 = self.solver2(locals1, self.offsets, G1, q1, posed1, self.skins,
                                           best_v, pts, w)
            posed2 = lbs_blend(G2, q2, G1, q1, posed1, self.skins)
            quats = matrix_to_quaternion(locals2)
        timer.mark("ik2")
        return posed2, vis_v, quats

    def step(self, track: TrackState, pts: np.ndarray) -> TrackState:
        verts = torch.as_tensor(track.verts, dtype=torch.float32, device=self.device)
        pts_t = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
        posed, vis, quats = self._frame(verts, pts_t, StageTimer(None, self.device))
        return TrackState(verts=posed.cpu().numpy(), quats=quats.cpu().numpy(),
                          vismask=vis.cpu().numpy())

    def run(self, vtx0: np.ndarray, pts_traj: np.ndarray):
        """Track over a (P, T, 3) trajectory from frame 0: (pred_vtx_traj
        (V, T-1, 3), vismasks (V, T-1), quats (J, T-1, 4))."""
        track = TrackState(verts=np.asarray(vtx0, np.float32), quats=None, vismask=None)
        verts_out, vis_out, quat_out = [], [], []
        for t in range(1, pts_traj.shape[1]):
            track = self.step(track, pts_traj[:, t, :])
            verts_out.append(track.verts)
            vis_out.append(track.vismask)
            quat_out.append(track.quats)
        return np.stack(verts_out, 1), np.stack(vis_out, 1), np.stack(quat_out, 1)


def make_scanned_tracker(tracker: Tracker):
    """Whole-sequence tracking with the state on the device between frames:
    run_host(vtx0 (nv,3), pts_traj (P,T,3), timings=None) -> (traj
    (nv,T-1,3), vismasks (nv,T-1), quats (J,T-1,4)).  With `timings`, adds
    seconds per part (flow, ik1, gate, ik2) summed over the frames,
    synchronizing the card at each mark."""
    dev = tracker.device

    def run_host(vtx0, pts_traj, timings: Optional[dict] = None):
        pts_seq = torch.as_tensor(np.transpose(np.asarray(pts_traj, np.float32)[:, 1:], (1, 0, 2)),
                                  device=dev)
        verts = torch.as_tensor(vtx0, dtype=torch.float32, device=dev)
        timer = StageTimer(timings, dev)
        outs = []
        for pts in pts_seq:
            verts, vis, quats = tracker._frame(verts, pts, timer)
            outs.append((verts, vis, quats))
        traj, vis, quats = (torch.stack(x, 1).cpu().numpy() for x in zip(*outs))
        return traj, vis, quats

    return run_host


class BatchedTracker:
    """Track N rigged meshes at once: one (N)-batch DeformNet forward per
    frame, then both IK stages and the gate batched over the rigs on their
    array topologies (padded to `max_joints`).  All meshes share the padded
    vertex count and the point count."""

    def __init__(self, deform: DeformNet, rigs: Sequence[sk.Rig], mesh_entries: Sequence[dict],
                 cfg: TrackingConfig = TrackingConfig(), max_joints: int = 32):
        assert len(rigs) == len(mesh_entries)
        self.deform, self.cfg = deform, cfg
        dev = self.device = next(deform.parameters()).device
        V = mesh_entries[0]["verts"].shape[0]
        Jm = max_joints
        parents_l, levels_l, offsets_l, skins_l, depth = [], [], [], [], 0
        for rig, entry in zip(rigs, mesh_entries):
            assert entry["verts"].shape[0] == V, "shared vertex pad required"
            J = rig.num_joints
            assert J <= Jm, (J, Jm)
            p, lv, d = topology_arrays(rig.parents, Jm)
            depth = max(depth, d)
            parents_l.append(p)
            levels_l.append(lv)
            off = np.zeros((Jm, 3), np.float32)
            off[:J] = rig.offsets()
            offsets_l.append(off)
            sk_p = np.zeros((V, Jm), np.float32)
            sk_p[:int(np.asarray(entry["vert_mask"]).sum()), :J] = rig.skins
            skins_l.append(sk_p)
        self.max_depth = depth

        def t(x, dtype=None):
            return torch.as_tensor(np.stack(x), dtype=dtype, device=dev)

        self.parents = t(parents_l, torch.int64)               # (B,Jm)
        self.levels = t(levels_l, torch.int64)
        self.offsets = t(offsets_l)                             # (B,Jm,3)
        self.skins = t(skins_l)                                 # (B,V,Jm)
        self.mesh_b = stack_meshes(list(mesh_entries), dev)
        self.vert_mask = self.mesh_b.vert_mask                  # (B,V)
        self.eye = torch.eye(3, device=dev).repeat(len(rigs), Jm, 1, 1)
        with highest_precision():
            self.G0, self.q0 = fk_masked(self.parents, self.levels, self.eye, self.offsets, depth)
        Bn, V = self.vert_mask.shape
        self.arange_v = torch.arange(V, device=dev).expand(Bn, V)
        ik1, ik2 = _ik_configs(cfg)
        self.solver1 = make_ik_solver_masked(depth, ik1)
        self.solver2 = make_ik_solver_masked(depth, ik2)

    def _corr_filter(self, vtx_f, pts_f, posed, pts, vismask):
        """The gate per mesh, padded vertices excluded from the argmax."""
        sim = vtx_f @ pts_f.transpose(-1, -2)                   # (B,V,P)
        sim = torch.where(self.vert_mask[..., None], sim, torch.full_like(sim, -1e30))
        return _gate(self.cfg, sim, posed, pts, vismask)

    @torch.no_grad()
    def _flow(self, verts_b, pts_b):
        mesh = dataclasses.replace(self.mesh_b, verts=verts_b)
        points = PointBatch(pts_b, torch.ones(pts_b.shape[:2], dtype=torch.bool,
                                              device=pts_b.device))
        pred_flow, vtx_f, pts_f, vis, _ = self.deform(mesh, points)
        return pred_flow, vtx_f, pts_f, vis

    def _frame(self, verts_b, pts_b, timer: StageTimer):
        pred_flow, vtx_f, pts_f, vis = self._flow(verts_b, pts_b)
        timer.mark("flow")
        with highest_precision():
            locals1, G1, q1 = self.solver1(
                self.eye, self.offsets, self.parents, self.levels, self.G0, self.q0,
                self.mesh_b.verts, self.skins, self.arange_v, verts_b + pred_flow, vis,
                self.vert_mask.float())
            posed1 = lbs_blend(G1, q1, self.G0, self.q0, self.mesh_b.verts, self.skins)
            timer.mark("ik1")
            best_v, w = self._corr_filter(vtx_f, pts_f, posed1, pts_b, vis)
            timer.mark("gate")
            locals2, G2, q2 = self.solver2(
                locals1, self.offsets, self.parents, self.levels, G1, q1, posed1, self.skins,
                best_v, pts_b, w, torch.ones_like(w))
            posed2 = lbs_blend(G2, q2, G1, q1, posed1, self.skins)
            quats = matrix_to_quaternion(locals2)
        timer.mark("ik2")
        return posed2, vis, quats

    def make_scanned(self):
        """run_host(vtx0_b (B,V,3) padded rest vertices, pts_traj_b
        (B,P,T,3), timings=None) -> (traj (B,V,T-1,3), vis (B,V,T-1), quats
        (B,Jm,T-1,4)); `timings` as in `make_scanned_tracker`."""
        dev = self.device

        def run_host(vtx0_b, pts_traj_b, timings: Optional[dict] = None):
            pts_seq = torch.as_tensor(np.transpose(np.asarray(pts_traj_b, np.float32)[:, :, 1:],
                                                   (2, 0, 1, 3)), device=dev)
            verts = torch.as_tensor(vtx0_b, dtype=torch.float32, device=dev)
            timer = StageTimer(timings, dev)
            outs = []
            for pts in pts_seq:
                verts, vis, quats = self._frame(verts, pts, timer)
                outs.append((verts, vis, quats))
            traj, vis, quats = (torch.stack(x, 2).cpu().numpy() for x in zip(*outs))
            return traj, vis, quats

        return run_host
