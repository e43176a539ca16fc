"""The port's convergence campaign (tools/torch_campaign.py,
tools/torch_eval_campaign_tracking.py) on the CPU.

tools/campaign.py is not imported here (its import points JAX's persistent
compile cache at a directory); its rules are restated instead:

  * both scripts import and print their help with jax, flax, optax,
    msgpack and the JAX package blocked;
  * `train_stage` at a tiny bone stage equals a direct `run_epochs_scanned`
    on the same seeds (campaign.py:73-121: init from `seed`, one epoch's
    schedule drawn before training, the training draws from seed + 1, the
    chunk rule of :113), a second call with done.json trains nothing and
    loads model_best, and a run cut mid-stage and resumed keeps the global
    best epoch of model_best's sidecar (:85-95), on a stage whose val loss
    is a table of its step count;
  * `pred_flow_for` against campaign.py:320-332 run on the JAX
    `DeformPoseStage.infer`, and the skin L1 against campaign.py:499-513
    applied to JAX `SkinStage.infer`'s logits, from the same weights
    (`weights.py`), the JAX side through its Pallas kernels in interpret
    mode;
  * the feature-size rule (:473-475) exactly, the summary's keys those of
    campaign_v4/campaign_summary.json (plus `device`), and the tracking
    evaluation end to end at a tiny size.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.data import pose as jpose
from morig_tpu.data import rig as jrig
from morig_tpu.nn import deformnet as jdn
from morig_tpu.train import stages as jstages
from morig_tpu.train import trainer as jtrainer
from morig_tpu_torch import weights as W
from morig_tpu_torch.core import config as tcfg
from morig_tpu_torch.data import pose as tpose
from morig_tpu_torch.data import rig as trig
from morig_tpu_torch.data import skeleton_data as tskel
from morig_tpu_torch.eval.metrics import joint_match_metrics
from morig_tpu_torch.train import checkpoint as tckpt
from morig_tpu_torch.train import scanned as tscan
from morig_tpu_torch.train import stages as tstages
from morig_tpu_torch.train import trainer as ttrainer

import torch_port_fixtures as F
from torch_port_fixtures import NETWORK, assert_rel_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
BLOCKED = ("jax", "flax", "optax", "msgpack", "morig_tpu")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tc = _load("torch_campaign")
te = _load("torch_eval_campaign_tracking")


# ---------------------------------------------------------------------------
# the scripts stand without JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script,flags", [
    ("torch_campaign", ("--dir", "--smoke", "--epochs-scale", "--batch-size",
                        "--train-creatures", "--dense-weight", "--recall-weight",
                        "--sep-weight", "--sep-alpha", "--device")),
    ("torch_eval_campaign_tracking", ("--dir", "--frames", "--points", "--target-verts",
                                      "--timing-iters", "--seeds", "--device")),
])
def test_script_runs_help_with_jax_blocked(script, flags):
    """Each script prints its help (every flag of its JAX counterpart, plus
    --device) in a process where jax, flax, optax, msgpack and morig_tpu
    cannot be imported, and imports as a module there."""
    code = textwrap.dedent(f"""
        import importlib.util, runpy, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        path = {os.path.join(TOOLS, script + ".py")!r}
        spec = importlib.util.spec_from_file_location("m", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        sys.argv = [path, "--help"]
        runpy.run_path(path, run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in flags:
        assert flag in out.stdout, flag


def test_defaults_match_the_jax_scripts():
    """The defaults of tools/campaign.py and tools/eval_campaign_tracking.py
    (read from their argparse lines, not imported), and --device cuda."""
    import re

    for script, parser in (("campaign", tc.build_parser()),
                           ("eval_campaign_tracking", te.build_parser())):
        with open(os.path.join(TOOLS, f"{script}.py")) as f:
            src = f.read()
        jax_flags = dict(re.findall(r'add_argument\("(--[\w-]+)"[^)]*?default=("[^"]*"|len\([^)]*\)|[^,)]+)',
                                    src))
        got = {a.option_strings[0]: a.default for a in parser._actions if a.option_strings}
        assert got["--device"] == "cuda"
        assert jax_flags.pop("--train-creatures", "len(TRAIN_SEEDS)") == "len(TRAIN_SEEDS)"
        assert got.pop("--train-creatures", len(tc.TRAIN_SEEDS)) == len(tc.TRAIN_SEEDS) == 12
        for flag, default in jax_flags.items():
            assert got[flag] == eval(default), (script, flag)
        assert set(jax_flags) | {"--smoke"} >= set(got) - {"--device", "-h"}


# ---------------------------------------------------------------------------
# train_stage
# ---------------------------------------------------------------------------

def _bone_batcher():
    sample = tskel.capsule_skel_dataset(num_models=2, max_joints=8, device="cpu",
                                        num_points=64, n_lat=7, n_lon=6)
    return tscan.const_scan_batcher(sample)


def _log(d: str) -> dict:
    out = {}
    with open(os.path.join(d, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out[(r["epoch"], r["split"])] = {k: v for k, v in r.items()
                                             if k not in ("time", "epoch_wall_s")}
    return out


def test_train_stage_equals_a_direct_scanned_run(tmp_path, monkeypatch):
    """A fresh train_stage of BoneStage (3 epochs, seed 0) against
    run_epochs_scanned from `init_state(0)`, one schedule drawn from
    default_rng(0) first, a generator seeded 1, chunks of `chunk_epochs(1)`:
    done.json's best epoch, the logs and the returned weights (the direct
    run's model_best.pt) equal.  Called again, it trains nothing and returns
    model_best's weights in the state it was given."""
    batcher = _bone_batcher()
    state = tc.train_stage(tstages.BoneStage(), "bone", str(tmp_path / "camp"), 3, batcher, "cpu")
    d = str(tmp_path / "camp" / "bone")
    with open(os.path.join(d, "done.json")) as f:
        done = json.load(f)

    stage = tstages.BoneStage()
    ref = stage.init_state(0, device="cpu")
    rng_np = np.random.default_rng(0)
    batcher.schedule(0, rng_np)
    direct = str(tmp_path / "direct")
    _, best = tscan.run_epochs_scanned(
        stage, ref, batcher, epochs=3, checkpoint_dir=direct,
        logger=ttrainer.MetricLogger(direct), generator=torch.Generator().manual_seed(1),
        rng_np=rng_np, chunk_epochs=tc.chunk_epochs(batcher.steps_per_epoch))
    assert tc.chunk_epochs(batcher.steps_per_epoch) == 25 and tc.chunk_epochs(3) == 24
    assert done["best_epoch"] == best and set(done) == {"best_epoch", "seconds"}
    assert _log(d) == _log(direct) and len(_log(d)) == 6
    saved = torch.load(os.path.join(direct, "model_best.pt"), weights_only=True)["model"]
    got = state.model.state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    assert sorted(os.listdir(d)) == ["checkpoint.pt", "checkpoint.pt.json", "done.json",
                                    "metrics.jsonl", "model_best.pt", "model_best.pt.json"]

    def trains(*a, **k):
        raise AssertionError("a done stage trained")

    monkeypatch.setattr(tscan, "run_epochs_scanned", trains)
    other = stage.init_state(5, device="cpu")
    again = tc.train_stage(tstages.BoneStage(), "bone", str(tmp_path / "camp"), 3, batcher,
                           "cpu", resume_state=other)
    assert again is other
    assert all(torch.equal(again.model.state_dict()[k], saved[k]) for k in saved)


class _Counter:
    """A one-parameter stage: each train step adds 1 to w, the val loss is
    table[w]; a train step at step count `cut` raises (a run cut there)."""

    def __init__(self, table, cut=None):
        self.table, self.cut = table, cut

    def on_epoch(self, epoch):
        pass

    def init_state(self, seed=0, device="cpu"):
        model = torch.nn.Module()
        model.w = torch.nn.Parameter(torch.zeros(()))
        return ttrainer.TrainState(model, ttrainer.multistep_adam(model.parameters(), 0.0, (),
                                                                  1.0, 0.0))

    def train_step(self, state, batch, generator=None, on_device=False):
        if state.step == self.cut:
            raise RuntimeError("run cut")
        with torch.no_grad():
            state.model.w.add_(1.0)
        state.step += 1
        return {"loss": state.model.w.detach().clone()}

    def eval_step(self, state, batch, on_device=False):
        return {"total_loss": torch.tensor(self.table[int(state.model.w.detach())])}


@pytest.mark.parametrize("torn", [False, True])
def test_resumed_stage_keeps_the_global_best(tmp_path, torn):
    """A run cut in epoch 3 (chunks of 1 epoch) after its best epoch 1, then
    resumed to epoch 5 without improving: the second call starts at the
    checkpoint's epoch 3 (with `torn`, checkpoint.pt cut in half, at
    model_best's epoch 2), done.json reports best epoch 1 (from model_best's
    sidecar: the resumed segment alone would report -1), the returned
    weights are epoch 1's, and the log holds every epoch (epoch 3 twice
    when resumed at 2)."""
    table = [9.0, 5.0, 4.0, 4.5, 6.0, 7.0]
    batcher = tscan.const_scan_batcher({"x": torch.zeros(1)})
    out = str(tmp_path)
    with pytest.raises(RuntimeError, match="run cut"):
        tc.train_stage(_Counter(table, cut=3), "c", out, 5, batcher, "cpu", chunk=1)
    d = os.path.join(out, "c")
    assert not os.path.exists(os.path.join(d, "done.json"))
    with open(os.path.join(d, "model_best.pt.json")) as f:
        assert json.load(f) == {"epoch": 2.0, "lowest_loss": 4.0}
    if torn:
        with open(os.path.join(d, "checkpoint.pt"), "r+b") as f:
            f.truncate(os.path.getsize(os.path.join(d, "checkpoint.pt")) // 2)
    state = tc.train_stage(_Counter(table), "c", out, 5, batcher, "cpu", chunk=1)
    with open(os.path.join(d, "done.json")) as f:
        assert json.load(f)["best_epoch"] == 1
    assert float(state.model.w.detach()) == 2.0
    log = _log(d)
    assert sorted({e for e, _ in log}) == [1, 2, 3, 4, 5]
    assert [log[(e, "val")]["total_loss"] for e in range(1, 6)] == table[1:]
    with open(os.path.join(d, "metrics.jsonl")) as f:
        assert len(f.readlines()) == (12 if torn else 10)


def test_flow_dump_roundtrip_and_torn_file(tmp_path):
    """pred_flows.npz: written atomically (no temporary file left), read back
    by split and model; a file cut in half, or one missing a model, reads
    as None (regenerate), as campaign.py:336-344."""
    rng = np.random.default_rng(0)
    flows = {s: [rng.random((n, 15), dtype=np.float32) for n in (5, 7)][:k]
             for s, k in (("tr", 2), ("val", 1), ("te", 1))}
    counts = {s: len(v) for s, v in flows.items()}
    path = str(tmp_path / "pred_flows.npz")
    assert tc.load_flows(path, counts) is None
    tc.save_flows(path, flows)
    assert os.listdir(tmp_path) == ["pred_flows.npz"]
    got = tc.load_flows(path, counts)
    assert all(np.array_equal(a, b) for s in flows for a, b in zip(got[s], flows[s]))
    assert tc.load_flows(path, dict(counts, tr=3)) is None
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert tc.load_flows(path, counts) is None


# ---------------------------------------------------------------------------
# the rig stages' flows and the skin L1, against the JAX stages
# ---------------------------------------------------------------------------

POSE = dict(num_models=2, num_frames=tc.POSE_FRAMES, num_points=128, n_lat=7, n_lon=6)


def test_pred_flow_for_matches_jax_infer(monkeypatch):
    """pred_flow_for on a two-capsule pose set (V=38 in 128, degree 12,
    P=128, frames 0-5) against campaign.py:320-332 run on the JAX
    DeformPoseStage.infer from the same weights: (V, 15) per model at
    NETWORK.  As in test_torch_pipeline's flow test, the port runs on the
    JAX mesh and point embeddings and vismask logits of each call (with
    random weights the kNN voting and the visibility threshold sit below
    bf16 noise)."""
    def sets(mod):
        ds = mod.capsule_pose_dataset(**POSE)
        return mod.PoseDataset(ds.models, tpl_max_degree=12, geo_max_degree=12, buckets=(128,))

    jds, tds = sets(jpose), sets(tpose)
    jstage = jstages.DeformPoseStage()
    b0 = jds.batch([0], 0, 1)
    params = F.flax_params(jdn.DeformNet(), 41, b0.mesh, b0.points, False)
    capture = lambda v, *a: jstage.model.apply(
        v, *a, capture_intermediates=lambda mdl, _: mdl.name == "lin_vismask",
        mutable=["intermediates"])
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats={}, opt_state=None, tx=None, apply_fn=capture)
    ref, embeds = [], []
    with F.jax_fused_kernels():
        for i in range(len(jds)):                   # campaign.py:320-332
            parts = []
            for t in range(1, 6):
                b = jds.batch([i], 0, t)
                (f, vtx_f, pts_f, _, _), inter = jstage.infer(jstate, b)
                vis = inter["intermediates"]["corr_extractor"]["lin_vismask"]["__call__"][0]
                embeds.append([torch.tensor(np.asarray(x)) for x in (vtx_f, pts_f, vis)])
                vm = np.asarray(b.mesh.vert_mask[0])
                parts.append(np.asarray(f[0])[vm])
            ref.append(np.concatenate(parts, axis=1).astype(np.float32))

    stage = tstages.DeformPoseStage()
    state = stage.init_state(0, device="cpu")
    state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
    corr = state.model.corr_extractor
    calls = iter(embeds)
    queued: list = []

    def mesh_enc(*_):
        queued[:] = next(calls)
        return queued[0]

    monkeypatch.setattr(corr.mesh_enc, "forward", mesh_enc)
    monkeypatch.setattr(corr.pts_enc, "forward", lambda *_: queued[1])
    monkeypatch.setattr(corr.lin_vismask, "forward", lambda *_: queued[2])
    got = tc.pred_flow_for(stage, state, tds, "cpu")
    assert next(calls, None) is None
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (38, 15) and g.dtype == np.float32
        assert_rel_close(g, r, NETWORK, what="pred_flow")


T_KEY = 2
JCFG = dataclasses.replace(jstages.DEFAULT_CONFIG, model=dataclasses.replace(
    jstages.DEFAULT_CONFIG.model, num_keyframes=T_KEY))
TCFG = dataclasses.replace(tcfg.DEFAULT_CONFIG, model=dataclasses.replace(
    tcfg.DEFAULT_CONFIG.model, num_keyframes=T_KEY))
# The port's skin L1 on its own SkinMotion against the formula on the JAX
# logits: the logits agree at NETWORK, and the L1 moves by the mean change of
# the probabilities it sums (measured 1.0e-3 and 1.7e-3 on L1s of 1.48 and
# 1.51 at these random weights).
SKIN_L1_TOL = 2e-3


def _jax_skin_l1(logits, b) -> float:
    """campaign.py:503-513 on one model's JAX logits and batch."""
    probs = np.asarray(jax.nn.softmax(logits[0], -1))
    vm = np.asarray(b.mesh.vert_mask[0])
    K = probs.shape[-1]
    lm = np.asarray(b.loss_mask[0])[:, :K]
    gt_lab = np.asarray(b.skin_label[0])[:, :K]
    p = probs * lm
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-9)
    g = gt_lab * lm
    g = g / np.maximum(g.sum(-1, keepdims=True), 1e-9)
    return float(np.abs(p - g).sum(-1)[vm].mean())


def test_skin_l1_matches_the_jax_formula(monkeypatch):
    """The skin L1 of two capsules (T=2 keyframes, V=38 in 128) from the same
    SkinMotion weights: the port's (its own logits, fp32 softmax) within
    SKIN_L1_TOL of campaign.py:503-513 on JAX SkinStage.infer's logits, and
    within 1e-6 of it when the port's network returns the JAX logits."""
    kw = dict(n_lat=7, n_lon=6, num_points=128, num_keyframes=T_KEY)
    pad = dict(pad_verts=128, tpl_max_degree=12, geo_max_degree=12)
    jds = jrig.RigDataset(jrig.capsule_rig_dataset(2, **kw).models, **pad)
    tds = trig.RigDataset(trig.capsule_rig_dataset(2, **kw).models, **pad)
    jstage = jstages.SkinStage(JCFG)
    jb = jds.batch([0])
    params = F.flax_params(jstage.model, 81, jb.skin_input, jb.pred_flow, jb.mesh)
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                                 opt_state=None, tx=None, apply_fn=jstage.model.apply)
    ref, logits = [], []
    with F.jax_fused_kernels():
        for i in range(2):
            b = jds.batch([i])
            _, _, lg = jstage.infer(jstate, b.skin_input, b.pred_flow, b.mesh)
            logits.append(torch.tensor(np.asarray(lg)))
            ref.append(_jax_skin_l1(lg, b))

    stage = tstages.SkinStage(TCFG)
    state = stage.init_state(0, device="cpu")
    state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
    got = [tc.skin_l1(stage, state, tds, i, "cpu") for i in range(2)]
    assert all(r > 0.1 for r in ref)
    np.testing.assert_allclose(got, ref, atol=SKIN_L1_TOL)
    queue = iter(logits)
    monkeypatch.setattr(state.model, "forward", lambda *_: (None, None, next(queue)))
    on_jax = [tc.skin_l1(stage, state, tds, i, "cpu") for i in range(2)]
    np.testing.assert_allclose(on_jax, ref, atol=1e-6)


@pytest.mark.parametrize("use_dg,use_lf", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_skin_descriptor_slice_has_no_host_index(use_dg, use_lf):
    """SkinMotion's descriptor columns equal JAX's `slice_skin_descriptor`
    for every flag pair, taken by slices: no `aten.index` with an index
    tensor built on the host.  Indexed by a list of columns, the slice
    copied that list to the card in every call, which the CUDA-graph capture
    of SkinStage's step refused (the campaign's skin stage on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from morig_tpu.nn import rignet as jrn
    from morig_tpu_torch.nn import rignet as trn

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    desc = np.random.default_rng(3).standard_normal((2, 7, 44)).astype(np.float32)
    with Ops() as ops:
        got = trn.slice_skin_descriptor(torch.as_tensor(desc), 5, use_dg, use_lf)
    ref = np.asarray(jrn.slice_skin_descriptor(jnp.asarray(desc), 5, use_dg, use_lf))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not [op for op in ops.seen if op.startswith("aten.index")], ops.seen


# ---------------------------------------------------------------------------
# the metrics' rules and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_sizes_rule(seed):
    """campaign.py:473-475 exactly, on joint sets whose half-distances fall
    below 0.03, inside the band and above 0.10."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (20, 3)) * (0.1, 0.4, 2.0)[seed]
    dj = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(dj, np.inf)
    ref = np.clip(0.5 * dj.min(1), 0.03, 0.10)
    got = tc.feature_sizes(pos)
    np.testing.assert_array_equal(got, ref)
    assert {0: (got == 0.03), 1: (got > 0.03) & (got < 0.10), 2: (got == 0.10)}[seed].any()


def test_summary_keys_match_campaign_v4():
    """`summarize` gives campaign_v4/campaign_summary.json's keys at every
    level (config, per_model entries as the held-out loop builds them, mean,
    loss_knobs, total_seconds) plus `device`."""
    with open(os.path.join(ROOT, "campaign_v4", "campaign_summary.json")) as f:
        v4 = json.load(f)
    rng = np.random.default_rng(0)
    gt, pred = rng.random((6, 3)), rng.random((5, 3))
    per_model = [dict(seed=200, num_pred_joints=5, num_gt_joints=6,
                      **joint_match_metrics(pred, gt, tc.feature_sizes(gt)))]
    terr = {"full_flow_error": 0.1, "vis_flow_error": 0.2}
    args = tc.build_parser().parse_args([])
    z = tc.sizes(args)
    config = dict(train=len(z["train"]), val=len(z["val"]), test=len(z["test"]),
                  epochs=z["E"], batch_size=z["bs"], target_verts=z["tv"], smoke=False)
    s = tc.summarize(config, per_model, [0.2], {"seq": terr, "discrete": terr},
                     dict(dense_weight=3.0, recall_weight=2.0), 1.0,
                     {"name": "cpu", "power_limit": None})
    assert set(s) == set(v4) | {"device"}
    assert set(s["mean"]) == set(v4["mean"])
    assert set(s["per_model"][0]) == set(v4["per_model"][0])
    assert s["config"] == dict(v4["config"])         # the full run's sizes are v4's
    assert set(s["loss_knobs"]) == set(v4["loss_knobs"])
    json.dumps(s)


def test_tracking_eval_runs_end_to_end(tmp_path):
    """tools/torch_eval_campaign_tracking.py on the CPU at a tiny size (one
    creature of ~300 vertices, 128 points, 2 frames, no timed runs) from a
    discrete DeformNet checkpoint: tracking_batched.json with JAX's keys and
    the device, finite flow errors, the .npz per creature."""
    stage = tstages.DeformPoseStage()
    tckpt.save_checkpoint(stage.init_state(0, device="cpu"), str(tmp_path / "deform"),
                          filename="model_best.pt", extra={"epoch": 1, "lowest_loss": 1.0})
    out = te.main(["--dir", str(tmp_path), "--frames", "2", "--points", "128",
                   "--target-verts", "300", "--timing-iters", "0", "--seeds", "200",
                   "--device", "cpu"])
    with open(tmp_path / "results" / "tracking_batched.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(out))
    assert set(saved) == {"per_model", "mean", "batched", "device"}
    assert set(saved["batched"]) >= {"num_meshes", "frames_per_mesh", "aggregate_frames_per_sec",
                                     "steady_seconds", "first_call_seconds", "points",
                                     "pad_verts"}
    assert saved["device"] == {"name": "cpu", "power_limit": None}
    assert np.isfinite([saved["mean"]["full_flow_error"], saved["mean"]["vis_flow_error"]]).all()
    with np.load(tmp_path / "results" / "creature200_tracking.npz") as z:
        assert z["pred_vtx_traj"].shape[1:] == (1, 3) and np.isfinite(z["pred_quats"]).all()
