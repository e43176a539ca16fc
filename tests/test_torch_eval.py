"""morig_tpu_torch's evaluation modules against morig_tpu's on the same
inputs: the metrics, the results-folder evaluations of rigs and tracks,
and the visualization exports.

Everything is numpy on both sides except the joint extraction of `eval
rig` from `_shift.ply` / `_attn.npy` artifacts, whose bandwidth and
mean-shift run in fp32 on each package's device code: those joints agree
within TIGHT (tests/test_torch_pipeline.py `test_extract_joints_matches_jax`),
so the chamfer of joints is held within TIGHT and the matched counts
exactly.
"""
from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch
from torch_port_fixtures import TIGHT

from morig_tpu.data import mesh_io as jio
from morig_tpu.data.synthetic import make_capsule_rig
from morig_tpu.eval import folder_eval as jfe
from morig_tpu.eval import metrics as jm
from morig_tpu.eval import visualize as jviz
from morig_tpu.geometry import skeleton as jsk
from morig_tpu.geometry import voxel as jvox
from morig_tpu_torch.eval import folder_eval as tfe
from morig_tpu_torch.eval import metrics as tm
from morig_tpu_torch.eval import visualize as tviz
from morig_tpu_torch.geometry import skeleton as tsk


def test_metrics_equal():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(40, 3)), rng.normal(size=(33, 3))
    bones_a, bones_b = rng.normal(size=(7, 6)), rng.normal(size=(9, 6))
    for name, args in (("chamfer_dist", (a, b)), ("oneway_chamfer", (a, b)),
                       ("joint2bone_chamfer", (bones_a, bones_b)),
                       ("bone2bone_chamfer", (bones_a, bones_b)),
                       ("mean_flow_l2", (a, a + 0.1 * rng.normal(size=a.shape))),
                       ("skin_l1", (rng.random((20, 5)), rng.random((20, 5))))):
        assert getattr(tm, name)(*args) == getattr(jm, name)(*args), name
    np.testing.assert_array_equal(tm.bone_samples(bones_a[:, :3], bones_a[:, 3:]),
                                  jm.bone_samples(bones_a[:, :3], bones_a[:, 3:]))
    gt = rng.normal(size=(12, 3))
    for pred, fs in ((gt[:10] + 0.03 * rng.normal(size=(10, 3)), 0.05),
                     (gt + 0.04 * rng.normal(size=gt.shape), rng.uniform(0.02, 0.08, 12)),
                     (np.zeros((0, 3)), 0.05)):
        assert tm.joint_match_metrics(pred, gt, fs) == jm.joint_match_metrics(pred, gt, fs)
    traj, gt_traj = rng.normal(size=(30, 5, 3)), rng.normal(size=(30, 5, 3))
    vis = rng.random((30, 5))
    assert tm.flow_errors(traj, gt_traj, vis) == jm.flow_errors(traj, gt_traj, vis)
    assert tm.flow_errors(traj, gt_traj) == jm.flow_errors(traj, gt_traj)
    vf, pf = rng.normal(size=(25, 8)), rng.normal(size=(30, 8))
    corr = np.stack([rng.integers(0, 25, 40), rng.integers(0, 30, 40)], 1)
    pts = rng.normal(size=(30, 3))
    assert tm.corr_accuracy_curve(vf, pf, corr, pts) == jm.corr_accuracy_curve(vf, pf, corr, pts)
    attn, mask = rng.normal(size=50), rng.random(50) > 0.6
    assert tm.attention_pr_curve(attn, mask) == jm.attention_pr_curve(attn, mask)


def _rig(mod, jitter, seed, V=66):
    rng = np.random.default_rng(seed)
    cap = make_capsule_rig(9, 8)
    skins = np.abs(rng.normal(size=(V, len(cap.names)))) * (rng.random((V, 1)) > 0.1)
    skins[:, 0] += 1e-3
    return mod.Rig(names=list(cap.names), pos=cap.joints + jitter * rng.normal(size=(len(
        cap.names), 3)), parents=cap.parents, skins=skins / skins.sum(1, keepdims=True))


def _rig_folders(root):
    """A results folder of two predictions (m1 with `_shift.ply` and
    `_attn.npy` artifacts, m2 without, m3 without a GT) and a GT folder with
    m1's voxel grid; the JAX package's evaluation gets a copy."""
    res, gt = root / "res", root / "gt"
    res.mkdir()
    gt.mkdir()
    cap = make_capsule_rig(9, 8)
    rng = np.random.default_rng(7)
    for i, name in enumerate(("m1", "m2", "m3")):
        _rig(jsk, 0.03, i).save(str(res / f"{name}_rig.txt"))
        if name != "m3":
            _rig(jsk, 0.0, 10 + i).save(str(gt / f"{name}_rig.txt"))
    centres = cap.joints[rng.integers(0, len(cap.joints), 300)]
    jio.write_ply_points(str(res / "m1_shift.ply"),
                         centres + 0.015 * rng.standard_normal(centres.shape))
    np.save(res / "m1_attn.npy", rng.random(300).astype(np.float32))
    jvox.write_binvox(jvox.voxelize_mesh(cap.verts, cap.faces, dims=32), str(gt / "m1.binvox"))
    shutil.copytree(res, root / "res_jax")
    return res, root / "res_jax", gt


def test_eval_rig_folder_matches_jax(tmp_path, capsys):
    res, res_jax, gt = _rig_folders(tmp_path)
    got = tfe.eval_rig_folder(str(res), str(gt), device="cpu")
    out = capsys.readouterr().out
    ref = jfe.eval_rig_folder(str(res_jax), str(gt))
    assert "[skip] m3" in out and "Joint IoU" in out
    assert set(got["per_model"]) == set(ref["per_model"]) == {"m1", "m2"}
    joints_close = ("chamfer_j2j",)
    for name, row in ref["per_model"].items():
        assert set(got["per_model"][name]) == set(row)
        for k, v in row.items():
            if k in joints_close:
                assert abs(got["per_model"][name][k] - v) <= TIGHT, (name, k)
            else:
                assert got["per_model"][name][k] == v, (name, k)
    assert got["per_model"]["m1"]["num_pred_joints"] != _rig(tsk, 0, 0).num_joints  # extracted
    for k, v in ref["mean"].items():
        assert abs(got["mean"][k] - v) <= (TIGHT if k in joints_close else 0.0), k
    zg, zr = np.load(res / "rig_eval.npz"), np.load(res_jax / "rig_eval.npz")
    assert sorted(zg.files) == sorted(zr.files)
    np.testing.assert_array_equal(zg["names"], zr["names"])


def test_eval_tracking_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for sub in ("res", "res_jax", "gt"):
        (tmp_path / sub).mkdir()
    V, T = 30, 6
    for name, with_vis in (("a", True), ("b", False)):
        gt_traj = rng.normal(size=(V, T, 3)).astype(np.float32)
        np.save(tmp_path / "gt" / f"{name}_vtx_traj.npy",
                gt_traj.reshape(V, -1) if with_vis else gt_traj)
        if with_vis:
            np.save(tmp_path / "gt" / f"{name}_vismask.npy", (rng.random((V, T)) > 0.3) * 1.0)
        pred = gt_traj[:, 1:] + 0.05 * rng.normal(size=(V, T - 1, 3))
        for sub in ("res", "res_jax"):
            np.savez(tmp_path / sub / f"{name}_tracking.npz", pred_vtx_traj=pred)
    np.savez(tmp_path / "res" / "c_tracking.npz", pred_vtx_traj=pred)      # no GT: skipped
    got = tfe.eval_tracking_folder(str(tmp_path / "res"), str(tmp_path / "gt"))
    ref = jfe.eval_tracking_folder(str(tmp_path / "res_jax"), str(tmp_path / "gt"))
    assert got == ref
    for name in ("a", "b"):
        zg = np.load(tmp_path / "res" / f"{name}_flow_errors.npz")
        zr = np.load(tmp_path / "res_jax" / f"{name}_flow_errors.npz")
        for k in ("full_flow_error", "vis_flow_error"):
            np.testing.assert_array_equal(zg[k], zr[k])


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_visualize_exports_byte_equal(tmp_path):
    rng = np.random.default_rng(5)
    verts, pts = rng.normal(size=(40, 3)), rng.normal(size=(25, 3))
    skins = rng.random((40, 6))
    trig, jrig = _rig(tsk, 0.0, 1), _rig(jsk, 0.0, 1)
    traj, pts_traj = rng.normal(size=(40, 23, 3)), rng.normal(size=(25, 23, 3))
    for mod, rig, sub in ((tviz, trig, "t"), (jviz, jrig, "j")):
        d = tmp_path / sub
        d.mkdir()
        mod.export_skinning(str(d / "skin.ply"), verts, skins)
        mod.export_attention(str(d / "attn.ply"), verts, np.arange(40.0))
        mod.export_correspondence(str(d / "cv.ply"), str(d / "cp.ply"), verts,
                                  np.cos(np.arange(320.0)).reshape(40, 8), pts,
                                  np.sin(np.arange(200.0)).reshape(25, 8))
        mod.export_flow(str(d / "flow.ply"), verts, 0.1 * verts)
        mod.export_skeleton_obj(str(d / "skel.obj"), rig)
        mod.export_tracking(str(d / "track"), "m", traj, pts_traj, stride=10)
    files = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*")
                   if p.is_file())
    assert len(files) == 9                       # 6 files, 3 tracking frames (stride 10)
    for f in files:
        assert _bytes(tmp_path / "t" / f) == _bytes(tmp_path / "j" / f), f
    np.testing.assert_array_equal(tviz.label_colormap(13), jviz.label_colormap(13))
    np.testing.assert_array_equal(tviz.heat_colors(verts[:, 0]), jviz.heat_colors(verts[:, 0]))


@pytest.mark.parametrize("num_pass", [0, 2])
def test_smooth_tracking_quats_matches_jax(num_pass):
    """Hemisphere alignment, temporal smoothing and the re-posing through
    float32 rotation matrices: trajectories within 1e-6, quaternions
    equal."""
    trig, jrig = _rig(tsk, 0.0, 2), _rig(jsk, 0.0, 2)
    rng = np.random.default_rng(num_pass)
    J, T = trig.num_joints, 7
    q = np.tile([0.0, 0.0, 0.0, 1.0], (J, T, 1)) + 0.2 * rng.normal(size=(J, T, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, 3] *= -1.0                                           # a sign flip mid-sequence
    rest = make_capsule_rig(9, 8).verts
    got = tviz.smooth_tracking_quats(trig, rest, q, num_pass=num_pass, device="cpu")
    ref = jviz.smooth_tracking_quats(jrig, rest, q, num_pass=num_pass)
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[0].dtype == ref[0].dtype == np.float32
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)


def test_smooth_tracking_quats_runs_on_the_card_by_default():
    """Without `device` the re-posing rotations are made on the card: on a
    host without one it raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    trig = _rig(tsk, 0.0, 2)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (trig.num_joints, 3, 1))
    with pytest.raises((AssertionError, RuntimeError)):
        tviz.smooth_tracking_quats(trig, make_capsule_rig(9, 8).verts, q)
