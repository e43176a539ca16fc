"""Evaluation metrics: chamfer families, Hungarian joint matching, flow and
correspondence metrics — a copy of morig_tpu/eval/metrics.py (numpy and
scipy).

Replaces utils/eval_utils.py:22-119 and the metric blocks of
evaluate/eval_rigging.py:111-121, evaluate/eval_corr.py:9-32,
evaluate/eval_deform.py, evaluate/eval_attn.py and eval_tracking.py:230-231.
Host-side numpy/scipy (tiny problems; the Hungarian assignment stays on host
per SURVEY.md §7 design move 4).
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def _dist_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sqrt(np.maximum(((a[:, None] - b[None]) ** 2).sum(-1), 0.0))


def chamfer_dist(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric mean-of-min chamfer (eval_utils / mst_utils.py:316-321)."""
    d = _dist_matrix(a, b)
    return float(0.5 * (d.min(1).mean() + d.min(0).mean()))


def oneway_chamfer(src: np.ndarray, tar: np.ndarray) -> float:
    return float(_dist_matrix(src, tar).min(1).mean())


def bone_samples(joints_a: np.ndarray, joints_b: np.ndarray, step: float = 0.01) -> np.ndarray:
    """Uniform samples along each bone segment, endpoints included."""
    out = []
    for p, c in zip(joints_a, joints_b):
        n = max(int(np.linalg.norm(c - p) / step), 1)
        t = np.linspace(0.0, 1.0, n + 1)[:, None]
        out.append(p[None] + t * (c - p)[None])
    return np.concatenate(out, 0)


def joint2bone_chamfer(pred_bones: np.ndarray, gt_bones: np.ndarray) -> float:
    """Chamfer between joint sets and opposing bone samples (eval_utils
    joint2bone semantics): pred joints vs gt bone samples and vice versa."""
    pred_j = np.concatenate([pred_bones[:, :3], pred_bones[:, 3:]], 0)
    gt_j = np.concatenate([gt_bones[:, :3], gt_bones[:, 3:]], 0)
    pred_s = bone_samples(pred_bones[:, :3], pred_bones[:, 3:])
    gt_s = bone_samples(gt_bones[:, :3], gt_bones[:, 3:])
    return float(0.5 * (oneway_chamfer(pred_j, gt_s) + oneway_chamfer(gt_j, pred_s)))


def bone2bone_chamfer(pred_bones: np.ndarray, gt_bones: np.ndarray) -> float:
    pred_s = bone_samples(pred_bones[:, :3], pred_bones[:, 3:])
    gt_s = bone_samples(gt_bones[:, :3], gt_bones[:, 3:])
    return chamfer_dist(pred_s, gt_s)


def joint_match_metrics(
    pred_joints: np.ndarray,
    gt_joints: np.ndarray,
    feature_sizes: np.ndarray | float = 0.05,
) -> dict:
    """Hungarian-matched joint IoU / precision / recall with per-GT-joint
    feature-size thresholds (eval_rigging.py:111-121)."""
    if len(pred_joints) == 0 or len(gt_joints) == 0:
        return dict(chamfer_j2j=np.inf, joint_IoU=0.0, joint_precision=0.0, joint_recall=0.0)
    fs = np.broadcast_to(np.asarray(feature_sizes, np.float64), (len(gt_joints),))
    d = _dist_matrix(gt_joints, pred_joints)
    row, col = linear_sum_assignment(d)
    hits = int((d[row, col] < fs[row]).sum())
    return dict(
        chamfer_j2j=chamfer_dist(pred_joints, gt_joints),
        joint_IoU=2.0 * hits / (len(pred_joints) + len(gt_joints)),
        joint_precision=hits / len(pred_joints),
        joint_recall=hits / len(gt_joints),
    )


def flow_errors(pred_traj: np.ndarray, gt_traj: np.ndarray,
                gt_vismask: np.ndarray | None = None) -> dict:
    """Tracking errors (eval_tracking.py:230-231): mean per-vertex L2 over
    all (V, T) and over visible entries only."""
    err = np.sqrt(((pred_traj - gt_traj) ** 2).sum(-1))  # (V, T)
    out = dict(full_flow_error=float(err.mean()))
    if gt_vismask is not None:
        vis = gt_vismask > 0.5
        out["vis_flow_error"] = float((err * vis).sum() / max(vis.sum(), 1))
    return out


def mean_flow_l2(pred_flow: np.ndarray, gt_flow: np.ndarray) -> float:
    """DeformNet metric (eval_deform.py): mean per-vertex flow L2."""
    return float(np.sqrt(((pred_flow - gt_flow) ** 2).sum(-1)).mean())


def corr_accuracy_curve(
    vtx_feature: np.ndarray, pts_feature: np.ndarray,
    corr_v2p: np.ndarray, pts_pos: np.ndarray,
    tolerances: np.ndarray | None = None,
) -> dict:
    """Correspondence accuracy vs distance tolerance (eval_corr.py:9-32):
    for each GT pair, the predicted nearest point (argmax feature similarity)
    must land within `tol` of the GT point's position."""
    if tolerances is None:
        tolerances = np.arange(0.02, 0.2001, 0.02)
    sim = vtx_feature @ pts_feature.T
    nn = sim.argmax(1)
    pred_pos = pts_pos[nn[corr_v2p[:, 0]]]
    gt_pos = pts_pos[corr_v2p[:, 1]]
    d = np.linalg.norm(pred_pos - gt_pos, axis=1)
    return {float(t): float((d < t).mean()) for t in tolerances}


def attention_pr_curve(pred_attn: np.ndarray, gt_mask: np.ndarray,
                       thresholds: np.ndarray | None = None) -> list[tuple[float, float, float]]:
    """Attention precision-recall (eval_attn.py): sweep thresholds over the
    min-max-normalized predicted attention."""
    a = (pred_attn - pred_attn.min()) / max(pred_attn.max() - pred_attn.min(), 1e-10)
    gt = gt_mask > 0.5
    if thresholds is None:
        thresholds = np.arange(0.05, 1.0, 0.05)
    out = []
    for t in thresholds:
        sel = a > t
        tp = int((sel & gt).sum())
        prec = tp / max(int(sel.sum()), 1)
        rec = tp / max(int(gt.sum()), 1)
        out.append((float(t), prec, rec))
    return out


def skin_l1(pred_skin: np.ndarray, gt_skin: np.ndarray) -> float:
    """Mean per-vertex L1 distance between skinning weight rows."""
    return float(np.abs(pred_skin - gt_skin).sum(-1).mean())
