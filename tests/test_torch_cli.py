"""morig_tpu_torch.cli against morig_tpu.cli, on the CPU (`--device cpu`) at
the capsule fixture size of tests/test_cli_handoff.py.

The port's CLI must offer the JAX CLI's subcommands and flags less the ones
that do not carry over (which argparse must reject), import without JAX,
draw the same epoch schedules from --seed, hand the corr checkpoint's
weights to the deform extractor bit for bit (from its own `.pt` and from a
JAX `.msgpack`), print the numbers the JAX CLI prints for one JAX-written
checkpoint, and write predict-rig's and track's files.

`eval` on a JAX checkpoint: the JAX CLI runs its Pallas kernels in
interpret mode (`jax_fused_kernels`), the port their plain versions; the
edge layers round to bf16 at the same points on both sides, so a network's
outputs agree within NETWORK (torch_port_fixtures).  The flow error is held
at NETWORK's mean bound, the printed accuracy and precision-recall rows
exactly.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_port_fixtures import NETWORK, jax_fused_kernels, random_params

from morig_tpu import cli as jcli
from morig_tpu.geometry import skeleton as jsk
from morig_tpu.train import checkpoint as jckpt
from morig_tpu_torch import cli as tcli
from morig_tpu_torch.train.checkpoint import load_flax_checkpoint
from morig_tpu_torch.train.stages import DeformPoseStage
from morig_tpu_torch.weights import flax_to_state_dict

FIXTURE = ["--data", "capsule", "--num-models", "1", "--fixture-points", "64",
           "--fixture-lat", "7", "--fixture-lon", "6", "--batch-size", "1"]
NOT_CARRIED_OVER = {"--platform", "--scan-epochs", "--edge-impl", "--edge-bwd", "--knn-impl"}


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _help(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(argv + ["--help"])
    return out.getvalue()


NEW_MODULES = ("cli", "data.loaders", "data.mesh_io", "data.preprocess", "eval.metrics",
               "eval.folder_eval", "eval.visualize", "geometry.segmentation",
               "geometry.registration", "geometry.kmeans", "losses.extras", "train.scanned",
               "train.graphs", "utils.profiling")


def test_cli_imports_without_jax():
    """The CLI and the modules it reaches import in a fresh process with no
    jax, flax, optax or morig_tpu module loaded."""
    code = ("import importlib, sys; [importlib.import_module('morig_tpu_torch.' + m) for m in "
            f"{NEW_MODULES!r}]; import morig_tpu_torch.cli as c; c.build_parser(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
            " 'morig_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _port_flags() -> dict:
    """Each subcommand's option strings, from the port's parser."""
    sub = next(a for a in tcli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {o for a in p._actions for o in a.option_strings} - {"-h", "--help"}
            for name, p in sub.choices.items()}


@pytest.mark.parametrize("cmd", ["train", "eval", "predict-rig", "track"])
def test_cli_flags_are_the_jax_clis(cmd):
    """Each subcommand's flags: the JAX CLI's (read from its --help), less the
    ones that do not carry over, plus --device; no `bench` subcommand."""
    ports = _port_flags()
    assert set(ports) == {"train", "eval", "predict-rig", "track"}
    ref = set(re.findall(r"(--[a-z][a-z-]+)", _help(jcli.main, [cmd]))) - {"--help"}
    # `train --edge-impl fused|windowed` picks the training forward (K1 or K5);
    # `train --scan-epochs N` runs train/scanned.py
    carried = {"--edge-impl", "--scan-epochs"} if cmd == "train" else set()
    assert ports[cmd] == (ref - NOT_CARRIED_OVER) | {"--device"} | carried


# the JAX CLI's `--edge-impl xla` (and "auto") has no counterpart: the port
# trains through its kernels, K1 or K5
@pytest.mark.parametrize("argv", [["--edge-impl", "xla"], ["--edge-bwd", "pallas"],
                                  ["--knn-impl", "fused"], ["--platform", "cpu"],
                                  ["--scan-epochs", "2"]])
def test_cli_rejects_jax_only_flags(argv):
    # --scan-epochs is a flag of `train` alone in the port
    cmd = ["eval", "corr"] if argv[0] == "--scan-epochs" else ["train", "corr_pose"]
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        tcli.main([*cmd, *FIXTURE, "--device", "cpu", *argv])
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        tcli.main(["bench", "--smoke"])


def test_cli_without_a_card_refuses_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["eval", "deform", *FIXTURE])


@pytest.mark.parametrize("stage,extra", [("corr_pose", []),
                                         ("corr_pose", ["--kind", "deformingthings"]),
                                         ("corr_pose", ["--sequential"]),
                                         ("joints", [])])
def test_cli_epoch_schedules_equal_jax(monkeypatch, tmp_path, stage, extra):
    """Both CLIs' training loops over 3 epochs of 3 capsules in batches of 2
    see the same (models, frame pair) batches, train and val, in the same
    order: the port's numpy draws are the JAX CLI's.  The steps themselves
    are replaced by a recorder."""
    import morig_tpu.data.pose as jpose
    import morig_tpu.data.rig as jrig
    import morig_tpu.train.stages as jstages
    import morig_tpu.train.trainer as jtrainer
    import morig_tpu_torch.data.pose as tpose
    import morig_tpu_torch.data.rig as trig
    import morig_tpu_torch.train.stages as tstages

    seen = {"jax": [], "torch": []}

    def recorder(side):
        def run_epochs(stage, state, train_batches, val_batches, test_batches, epochs, **kw):
            for e in range(epochs):
                seen[side].append(("train", list(train_batches(e))))
                seen[side].append(("val", list(val_batches())))
            return state, 0
        return run_epochs

    for mod in (jpose, tpose):
        monkeypatch.setattr(mod.PoseDataset, "batch",
                            lambda self, idx, src, tar, *a, **k: (tuple(idx), src, tar))
    for mod in (jrig, trig):
        monkeypatch.setattr(mod.RigDataset, "batch", lambda self, idx, *a, **k: tuple(idx))
    for mod in (jstages, tstages):
        for cls in ("CorrPoseStage", "RigStage"):
            monkeypatch.setattr(getattr(mod, cls), "init_state", lambda self, *a, **k: None)
    monkeypatch.setattr(jtrainer, "run_epochs", recorder("jax"))
    monkeypatch.setattr(tcli, "run_epochs", recorder("torch"))
    argv = ["train", stage, "--data", "capsule", "--num-models", "3", "--fixture-points", "64",
            "--fixture-lat", "7", "--fixture-lon", "6", "--batch-size", "2", "--epochs", "3",
            "--seed", "4", "--logdir", str(tmp_path / "logs"), *extra]
    _run(jcli.main, argv + ["--platform", "cpu"])
    _run(tcli.main, argv + ["--device", "cpu"])
    assert seen["torch"] == seen["jax"] and len(seen["jax"]) == 6
    assert len({str(b) for split, bs in seen["jax"] if split == "train" for b in bs}) > 1


def _leaves(sd, prefix=""):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_cli_corr_to_deform_handoff(tmp_path):
    """train corr_pose, then train deform_pose --init-extractor with the
    port's checkpoint and with a JAX CLI checkpoint: the extractor equals the
    CorrNet bit for bit after a deform epoch (frozen), the refiner moved."""
    ck = {k: str(tmp_path / k) for k in ("corr", "deform", "deform_jax", "logs")}
    common = [*FIXTURE, "--device", "cpu", "--epochs", "1"]
    tcli.main(["train", "corr_pose", *common, "--checkpoint", ck["corr"], "--logdir",
               ck["logs"] + "1"])
    corr = torch.load(os.path.join(ck["corr"], "checkpoint.pt"), weights_only=True)["model"]
    tcli.main(["train", "deform_pose", *common, "--checkpoint", ck["deform"], "--logdir",
               ck["logs"] + "2", "--init-extractor", os.path.join(ck["corr"], "checkpoint.pt")])
    deform = torch.load(os.path.join(ck["deform"], "checkpoint.pt"), weights_only=True)["model"]
    ext = _leaves(deform, "corr_extractor.")
    assert set(ext) == set(corr)
    for k, v in corr.items():
        assert torch.equal(ext[k], v), k
    fresh = DeformPoseStage().init_state(0, "cpu").model.state_dict()
    assert any(not torch.equal(v, fresh[k]) for k, v in deform.items()
               if not k.startswith("corr_extractor."))

    jax_corr = _jax_checkpoint(tmp_path / "jax_corr", "corr")
    tcli.main(["train", "deform_pose", *common, "--checkpoint", ck["deform_jax"], "--logdir",
               ck["logs"] + "3", "--init-extractor", jax_corr])
    deform = torch.load(os.path.join(ck["deform_jax"], "checkpoint.pt"), weights_only=True)
    ext = _leaves(deform["model"], "corr_extractor.")
    ref = flax_to_state_dict(load_flax_checkpoint(jax_corr)["params"])
    assert set(ext) == set(ref)
    for k, v in ref.items():
        assert torch.equal(ext[k], v), k


def _jax_args(**kw):
    base = dict(data="capsule", num_models=1, fixture_points=64, fixture_lat=7, fixture_lon=6,
                seed=0, kind="modelsresource", sequential=False, batch_size=1)
    return argparse.Namespace(**{**base, **kw})


def _jax_state(what):
    """A JAX init_state of the stage `eval what` evaluates, on the eval
    batch, its parameters replaced by seeded values at a trained net's scale
    (flax's init leaves zero heads, whose outputs would not tell the
    sides apart)."""
    from morig_tpu.data.pose import eval_frame_pair
    from morig_tpu.train.stages import CorrPoseStage, RigStage
    from morig_tpu.train.stages import DeformPoseStage as JaxDeformPoseStage

    args = _jax_args()
    if what == "attn":
        ds = jcli._rig_dataset(args)
        stage = RigStage(arch="masknet", num_embed_sample=min(512, ds.pad_verts))
        batch = ds.batch([0])
    else:
        ds = jcli._pose_dataset(args)
        src, tar = eval_frame_pair(False)
        batch = ds.batch([0], src, min(tar, 5))
        stage = CorrPoseStage() if what == "corr" else JaxDeformPoseStage()
    state = stage.init_state(jax.random.key(1), batch)
    params = random_params(jax.device_get(state.params), seed=11)
    return stage, state.replace(params=params)


def _jax_checkpoint(folder, what) -> str:
    _, state = _jax_state(what)
    jckpt.save_checkpoint(state, str(folder))
    return os.path.join(str(folder), "checkpoint.msgpack")


def _numbers(text: str, key: str) -> list[float]:
    return [float(x) for x in re.findall(rf"{key} (-?[0-9.]+)", text)]


def _capsule_folder(folder) -> str:
    """One capsule (the 7 x 6 fixture, 128 points, 6 frames) in the
    reference layout, pose and rig files together, its GT attention the
    vertices within 0.13 of a joint (the fixture's own 0.08 radius holds no
    vertex: every one is 0.12 from the capsule's axis)."""
    from morig_tpu.data.synthetic import make_capsule_sequence

    seq = make_capsule_sequence(num_frames=6, num_points=128, n_lat=7, n_lon=6)
    cap = seq["rig"]
    pre = os.path.join(folder, "cap")
    os.makedirs(folder)
    for key in ("vtx_traj", "pts_traj", "corr_v2p", "corr_p2v", "vismask"):
        np.save(f"{pre}_{key}.npy", seq[key])
    np.savetxt(pre + "_tpl_e.txt", seq["tpl_edges"], fmt="%d")
    np.savetxt(pre + "_geo_e.txt", seq["geo_edges"], fmt="%d")
    jsk.Rig(names=list(cap.names), pos=cap.joints.astype(float), parents=cap.parents,
            skins=cap.skins).save(pre + "_rig.txt")
    d = np.linalg.norm(cap.verts[:, None] - cap.joints[None], axis=-1).min(1)
    np.savetxt(pre + "_attn.txt", (d < 0.13).astype(np.float32))
    assert 0 < (d < 0.13).sum() < len(d)
    return folder


@pytest.mark.parametrize("what", ["corr", "deform", "attn"])
def test_cli_eval_matches_jax_on_a_jax_checkpoint(tmp_path, what):
    """`eval corr|deform` on the capsule fixture with 128 points (the JAX
    kNN runs its fused bf16 kernel only where the point count is a multiple
    of 128; below, its fp32 XLA similarity flips near ties against the
    port's bf16 K2), `eval attn` on a reference-layout folder: the same
    accuracies and precision-recall rows, and the flow error within
    NETWORK's mean bound."""
    path = _jax_checkpoint(tmp_path / "ckpt", what)
    data = ["--data", _capsule_folder(str(tmp_path / "data")), "--sequential"] \
        if what == "attn" else [*FIXTURE[:5], "128", *FIXTURE[6:]]
    data = data + ["--batch-size", "1", "--resume", path]
    with jax_fused_kernels():
        ref = _run(jcli.main, ["eval", what, *data, "--platform", "cpu"])
    got = _run(tcli.main, ["eval", what, *data, "--device", "cpu"])
    if what == "deform":
        g, r = _numbers(got, "mean flow L2:"), _numbers(ref, "mean flow L2:")
        assert len(g) == len(r) == 1 and abs(g[0] - r[0]) <= NETWORK[0] * r[0], (got, ref)
        return
    rows = ("tolerance", "accuracy") if what == "corr" else ("threshold", "precision", "recall")
    for k in rows:
        g, r = _numbers(got, k), _numbers(ref, k)
        assert len(g) == len(r) == (10 if what == "corr" else 19) and g == r, (k, got, ref)
    assert max(_numbers(ref, rows[1])) > 0, ref


def test_cli_predict_rig_and_eval_rig(tmp_path):
    """predict-rig --train-steps 2 --save-intermediates writes each capsule's
    rig and artifacts; a second run skips what exists, --force redoes it;
    eval rig reads them back."""
    out = str(tmp_path / "res")
    base = ["predict-rig", "--device", "cpu", "--out", out]
    text = _run(tcli.main, base + ["--train-steps", "2", "--save-intermediates"])
    names = ("capsule0", "capsule1")
    for n in names:
        for suffix in ("_rig.txt", "_shift.ply", "_attn.npy", "_gt_rig.txt"):
            assert os.path.exists(os.path.join(out, n + suffix)), n + suffix
        assert f"{n}: " in text and "joints ->" in text
    assert _run(tcli.main, base + ["--train-steps", "0"]).count("exists, skipped") == 2
    assert _run(tcli.main, base + ["--train-steps", "0", "--force"]).count("joints ->") == 2
    text = _run(tcli.main, ["eval", "rig", "--device", "cpu", "--res", out, "--gt", out])
    assert "Joint IoU" in text
    ev = np.load(os.path.join(out, "rig_eval.npz"))
    assert list(ev["names"]) == list(names)
    assert all(np.isfinite(ev[k]) for k in ev.files if k.startswith("mean_"))


def test_cli_track_and_eval_tracking(tmp_path):
    """track --frames 3 writes capsule_tracking.npz with the JAX CLI's keys
    and the smoothed overlay PLY; eval tracking reads it back."""
    out = str(tmp_path / "track")
    _run(tcli.main, ["track", "--device", "cpu", "--out", out, "--frames", "3"])
    z = np.load(os.path.join(out, "capsule_tracking.npz"))
    assert sorted(z.files) == sorted(["pred_vtx_traj", "pred_vismask", "pred_quats",
                                      "pred_vtx_traj_smooth", "pred_quats_smooth",
                                      "full_flow_error", "vis_flow_error"])
    assert z["pred_vtx_traj"].shape[1] == 2 and np.isfinite(z["pred_vtx_traj"]).all()
    assert os.path.exists(os.path.join(out, "capsule_smooth_frame000.ply"))
    from morig_tpu_torch.data.synthetic import make_capsule_sequence

    gt = tmp_path / "gt"
    gt.mkdir()
    seq = make_capsule_sequence(num_frames=3, num_points=256)
    np.save(gt / "capsule_vtx_traj.npy", seq["vtx_traj"])
    np.save(gt / "capsule_vismask.npy", seq["vismask"])
    text = _run(tcli.main, ["eval", "tracking", "--device", "cpu", "--res", out, "--gt", str(gt)])
    assert _numbers(text, "mean full flow error") == pytest.approx(
        [float(z["full_flow_error"])], abs=1e-5)


def test_cli_train_scan_epochs(tmp_path):
    """`train corr_pose --scan-epochs 2` on the CPU (3 epochs: chunks of 2
    and 1) writes checkpoint.pt, model_best.pt and a metrics.jsonl whose
    every line has `epoch_wall_s`, and trains the weights `--scan-epochs 0`
    (the loop) trains, bit for bit."""
    weights = {}
    for scan in ("2", "0"):
        ck, logs = tmp_path / f"ck{scan}", tmp_path / f"logs{scan}"
        out = _run(tcli.main, ["train", "corr_pose", *FIXTURE, "--num-models", "2",
                               "--batch-size", "2", "--epochs", "3", "--device", "cpu",
                               "--scan-epochs", scan, "--checkpoint", str(ck),
                               "--logdir", str(logs)])
        assert "best epoch:" in out
        assert {"checkpoint.pt", "model_best.pt"} <= set(os.listdir(ck))
        with open(logs / "metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        assert [(r["epoch"], r["split"]) for r in records] == \
            [(e, s) for e in (1, 2, 3) for s in ("train", "val")]
        assert all(("epoch_wall_s" in r) == (scan == "2") for r in records)
        weights[scan] = torch.load(ck / "checkpoint.pt", weights_only=True)["model"]
    assert all(torch.equal(weights["2"][k], weights["0"][k]) for k in weights["0"])


def test_cli_scan_epochs_multi_bucket_pose_set(monkeypatch, tmp_path):
    """A pose set over two vertex buckets cannot be scanned: the JAX CLI's
    message, then the per-batch loop (no `epoch_wall_s` in the log)."""
    from morig_tpu_torch.data.pose import PoseDataset, capsule_pose_dataset

    small = capsule_pose_dataset(num_models=1, num_frames=6, num_points=64, n_lat=7, n_lon=6)
    large = capsule_pose_dataset(num_models=1, num_frames=6, num_points=64, n_lat=17, n_lon=16)
    ds = PoseDataset(small.models + large.models)
    assert len(set(ds.bucket_of)) == 2
    monkeypatch.setattr(tcli, "_pose_dataset", lambda args, shape=False: ds)
    logs = tmp_path / "logs"
    out = _run(tcli.main, ["train", "corr_pose", *FIXTURE, "--epochs", "1", "--device", "cpu",
                           "--scan-epochs", "2", "--checkpoint", str(tmp_path / "ck"),
                           "--logdir", str(logs)])
    assert ("[train] --scan-epochs needs a single vertex bucket; falling back to the "
            "per-batch loop") in out
    with open(logs / "metrics.jsonl") as f:
        assert not any("epoch_wall_s" in json.loads(line) for line in f)
