"""Results-folder batch evaluation — the reference's offline eval workflow;
a copy of morig_tpu/eval/folder_eval.py on the port's modules (joints from
the `_shift.ply` / `_attn.npy` artifacts through the port's
`extract_joints` and `inside_check_np`).

Covers evaluate/eval_rigging.py:48-131 (shifted-points + attention artifacts
-> joints -> Hungarian metrics vs GT, or predicted-rig files directly) and
eval_tracking.py:213-235 (predicted trajectories vs GT trajectories -> per-
frame full/visible flow-error arrays saved as npz).  Invoked via the CLI:

  python -m morig_tpu_torch.cli eval rig      --res results/ --gt data/
  python -m morig_tpu_torch.cli eval tracking --res results/ --gt data/

Artifact layout per model `name` in the results folder:
  {name}_rig.txt        predicted rig (pipelines/rig_predict output)
  {name}_shift.ply      [optional] shifted points (train_rig.py:264 dump)
  {name}_attn.npy       [optional] attention weights for the shifted points
  {name}_tracking.npz   predicted trajectories (pipelines/tracking output)
and in the GT folder:
  {name}_rig.txt        GT rig;  {name}.binvox [optional] voxel grid
  {name}_vtx_traj.npy   GT vertex trajectories;  {name}_vismask.npy
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from morig_tpu_torch.data.mesh_io import read_ply_points
from morig_tpu_torch.eval.metrics import (
    bone2bone_chamfer,
    flow_errors,
    joint2bone_chamfer,
    joint_match_metrics,
    skin_l1,
)
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.clustering import extract_joints
from morig_tpu_torch.geometry.voxel import inside_check_np, read_binvox


def joint_feature_sizes(gt_joints: np.ndarray, lo: float = 0.03,
                        hi: float = 0.10) -> np.ndarray:
    """Per-GT-joint match threshold: half the distance to the nearest other
    joint, clipped — a shape-derived stand-in for the reference's per-model
    feature-size files (eval_rigging.py:111-121)."""
    if len(gt_joints) < 2:
        return np.full(len(gt_joints), hi)
    d = np.linalg.norm(gt_joints[:, None] - gt_joints[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return np.clip(0.5 * d.min(1), lo, hi)


def _pred_joints_from_artifacts(res_folder: str, name: str, gt_folder: str,
                                device) -> Optional[np.ndarray]:
    """eval_rigging.py:66-110 joint extraction when shift/attn dumps exist:
    inside-check -> attn filter -> symmetrize -> mean-shift (on `device`)
    -> NMS -> flip."""
    shift_path = os.path.join(res_folder, f"{name}_shift.ply")
    attn_path = os.path.join(res_folder, f"{name}_attn.npy")
    if not (os.path.exists(shift_path) and os.path.exists(attn_path)):
        return None
    shifted = read_ply_points(shift_path)
    attn = np.load(attn_path).reshape(-1)
    inside_fn = None
    for folder in (gt_folder, res_folder):
        bv = os.path.join(folder, f"{name}.binvox")
        if os.path.exists(bv):
            vox = read_binvox(bv)
            inside_fn = lambda p, v=vox: inside_check_np(p, v)
            break
    return extract_joints(shifted, attn, inside_fn=inside_fn, device=device)


def eval_rig_folder(res_folder: str, gt_folder: str, write_npz: bool = True,
                    device="cuda") -> dict:
    """Batch rig evaluation over a results folder; prints the reference's
    metric block (eval_rigging.py:127-131) and returns the aggregate dict.
    The mean-shift of the joint extraction runs on `device` (the card
    unless the caller asks for another)."""
    names = sorted(
        os.path.basename(p)[: -len("_rig.txt")]
        for p in glob.glob(os.path.join(res_folder, "*_rig.txt"))
        if not p.endswith("_gt_rig.txt")
    )
    if not names:
        raise FileNotFoundError(f"no *_rig.txt in {res_folder}")
    rows = []
    for name in names:
        # prefer the explicit _gt_rig artifact: with --res and --gt pointing
        # at the same results folder, {name}_rig.txt is the PREDICTION
        gt_path = os.path.join(gt_folder, f"{name}_gt_rig.txt")
        if not os.path.exists(gt_path):
            gt_path = os.path.join(gt_folder, f"{name}_rig.txt")
        if not os.path.exists(gt_path) or os.path.samefile(
                gt_path, os.path.join(res_folder, f"{name}_rig.txt")):
            print(f"  [skip] {name}: no GT rig in {gt_folder}")
            continue
        pred = sk.Rig.load(os.path.join(res_folder, f"{name}_rig.txt"))
        gt = sk.Rig.load(gt_path)

        pj = _pred_joints_from_artifacts(res_folder, name, gt_folder, device)
        if pj is None:
            pj = pred.pos
        fs = joint_feature_sizes(gt.pos)
        row = joint_match_metrics(pj, gt.pos, fs)

        pred_bones, _, _ = sk.get_bones(pred)
        gt_bones, _, _ = sk.get_bones(gt)
        row["chamfer_j2b"] = joint2bone_chamfer(pred_bones, gt_bones)
        row["chamfer_b2b"] = bone2bone_chamfer(pred_bones, gt_bones)
        if (pred.skins is not None and gt.skins is not None
                and pred.skins.shape[0] == gt.skins.shape[0]):
            # skin rows are per-joint in each rig's own joint order; compare
            # the per-vertex TOTAL weight placement via nearest-GT-joint
            # remapping of predicted columns
            d = np.linalg.norm(pred.pos[:, None] - gt.pos[None], axis=-1)
            remap = d.argmin(1)
            proj = np.zeros_like(gt.skins)
            for c, g in enumerate(remap):
                proj[:, g] += pred.skins[:, c]
            row["skin_L1"] = skin_l1(proj, gt.skins)
        row["num_pred_joints"] = len(pj)
        row["num_gt_joints"] = gt.num_joints
        rows.append((name, row))

    if not rows:
        raise FileNotFoundError(
            f"no predictions in {res_folder} had a GT rig in {gt_folder}")
    agg = {}
    for key in ("chamfer_j2j", "joint_IoU", "joint_precision", "joint_recall",
                "chamfer_j2b", "chamfer_b2b"):
        agg[key] = float(np.mean([r[key] for _, r in rows]))
    skins = [r["skin_L1"] for _, r in rows if "skin_L1" in r]
    if skins:
        agg["skin_L1"] = float(np.mean(skins))
    # the reference's printed block (eval_rigging.py:127-131)
    print(f"J2J Chamfer distance {agg['chamfer_j2j'] * 100:.3f} %")
    print(f"Joint IoU {agg['joint_IoU'] * 100:.3f} %")
    print(f"Joint precision {agg['joint_precision'] * 100:.3f} %")
    print(f"Joint recall {agg['joint_recall'] * 100:.3f} %")
    if write_npz:
        out = os.path.join(res_folder, "rig_eval.npz")
        # names must align with the metric rows: models skipped for missing
        # GT are excluded from BOTH
        np.savez(out, names=np.array([n for n, _ in rows]),
                 **{k: np.array([r.get(k, np.nan) for _, r in rows])
                    for k in rows[0][1]},
                 **{f"mean_{k}": v for k, v in agg.items()})
        print(f"per-model metrics -> {out}")
    return dict(per_model=dict(rows), mean=agg)


def eval_tracking_folder(res_folder: str, gt_folder: str,
                         write_npz: bool = True) -> dict:
    """Batch tracking evaluation (eval_tracking.py:213-235): per model the
    per-frame full/visible flow-error arrays + test-set means."""
    names = sorted(
        os.path.basename(p)[: -len("_tracking.npz")]
        for p in glob.glob(os.path.join(res_folder, "*_tracking.npz"))
    )
    if not names:
        raise FileNotFoundError(f"no *_tracking.npz in {res_folder}")
    fulls, viss, rows = [], [], []
    for name in names:
        z = np.load(os.path.join(res_folder, f"{name}_tracking.npz"))
        pred = z["pred_vtx_traj"]                       # (V, T, 3)
        gt_path = os.path.join(gt_folder, f"{name}_vtx_traj.npy")
        if not os.path.exists(gt_path):
            print(f"  [skip] {name}: no GT trajectory in {gt_folder}")
            continue
        gt_traj = np.load(gt_path)
        if gt_traj.ndim == 2:
            gt_traj = gt_traj.reshape(len(gt_traj), -1, 3)
        vis_path = os.path.join(gt_folder, f"{name}_vismask.npy")
        vis = np.load(vis_path) if os.path.exists(vis_path) else None
        # tracking predicts frames 1..T; GT includes frame 0
        T = min(pred.shape[1], gt_traj.shape[1] - 1)
        gt_t = gt_traj[:, 1:T + 1, :]
        vis_t = vis[:, 1:T + 1] if vis is not None else None
        err = np.sqrt(((pred[:, :T] - gt_t) ** 2).sum(-1))   # (V, T)
        full_per_frame = err.mean(0)
        row = flow_errors(pred[:, :T], gt_t, vis_t)
        if vis_t is not None:
            v = vis_t > 0.5
            vis_per_frame = (err * v).sum(0) / np.maximum(v.sum(0), 1)
        else:
            vis_per_frame = full_per_frame
        fulls.append(row["full_flow_error"])
        viss.append(row.get("vis_flow_error", row["full_flow_error"]))
        rows.append((name, row))
        if write_npz:
            out = os.path.join(res_folder, f"{name}_flow_errors.npz")
            np.savez(out, full_flow_error=full_per_frame,
                     vis_flow_error=vis_per_frame)
    if not rows:
        raise FileNotFoundError(
            f"no predictions in {res_folder} had a GT trajectory in {gt_folder}")
    agg = dict(full_flow_error=float(np.mean(fulls)),
               vis_flow_error=float(np.mean(viss)))
    print(f"mean full flow error {agg['full_flow_error']:.5f}")
    print(f"mean visible flow error {agg['vis_flow_error']:.5f}")
    return dict(per_model=dict(rows), mean=agg)
