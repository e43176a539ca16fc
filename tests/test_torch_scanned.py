"""The port's epoch-scanned training (morig_tpu_torch/train/scanned.py) on
the CPU: against the port's own loop (`run_epochs`) and against the JAX
package's runners.

On a CPU state `run_epochs_scanned` runs the programs it captures into CUDA
graphs on the card eagerly: the same device-resident gathers, cursors and
on-device best-on-val.  Against the port's loop, for CorrPoseStage (with a
chunk split at the visibility branch and a chunk cut short), RigStage
jointnet and BoneStage at the capsule fixture of tests/test_scanned_train.py
(num_points=64, n_lat=7, n_lon=6): the final parameters and buffers and the
best epoch equal, the per-epoch metrics within 1e-6 relative (the loop
averages its floats in float64, the runner its fp32 device scalars).  Both
steps run the same ops on the same batches and generator stream, one
thread, so the parameters are equal bit for bit.

Against the JAX package: `_chunk_ranges` over a grid; each batcher's gather
of one epoch's schedule, every field equal (JAX's indices are int32, the
port's int64: compared by value); the logger's record layout; early stop,
resume and best-on-val on a one-parameter stage whose val loss is a table
of its step count (both packages' runners, both loops), so the semantics
are compared exactly; and a whole `run_epochs_scanned` of RootStage (no
draws), 2 epochs in chunks of 1, from the same weights (`weights.py`),
against JAX's at the skeleton step tests' tolerances.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morig_tpu.data import pose as jpose
from morig_tpu.data import rig as jrig
from morig_tpu.data import skeleton_data as jskel
from morig_tpu.train import scanned as jscan
from morig_tpu.train import trainer as jtrainer
from morig_tpu_torch.data import pose as tpose
from morig_tpu_torch.data import rig as trig
from morig_tpu_torch.data import skeleton_data as tskel
from morig_tpu_torch.train import scanned as tscan
from morig_tpu_torch.train import trainer as ttrainer
from morig_tpu_torch.train.stages import BoneStage, CorrPoseStage, RigStage

torch.set_num_threads(1)

KW = dict(num_points=64, n_lat=7, n_lon=6)
MESH_KEYS = ("verts", "vert_mask", "tpl_nbr", "tpl_mask", "geo_nbr", "geo_mask")
LOG_RTOL = 1e-6


def _read_log(d) -> dict:
    out = {}
    with open(os.path.join(d, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out[(r["epoch"], r["split"])] = {k: v for k, v in r.items()
                                             if k not in ("epoch", "split", "time",
                                                          "epoch_wall_s")}
    return out


# ---------------------------------------------------------------------------
# the scanned runner against the port's loop
# ---------------------------------------------------------------------------

def _corr_case():
    tr = tpose.capsule_pose_dataset(num_models=3, num_frames=4, **KW)
    va = tpose.capsule_pose_dataset(num_models=2, num_frames=4, seed=9, **KW)

    def loop(rng, train):
        ds = tr if train else va
        return ds.epoch_batches(rng, 2, "modelsresource", False, train, device="cpu")

    def make():
        stage = CorrPoseStage()
        stage.vis_branch_start_epoch = 1      # chunks [0, 1) and [1, 3)
        return stage

    batcher = tscan.with_val_dataset(
        tscan.pose_scan_batcher(tr, 2, "modelsresource", False, device="cpu"),
        tscan.pose_scan_batcher(va, 2, "modelsresource", False, device="cpu"))
    return make, loop, batcher, 3, 2


def _rig_case():
    tr = trig.capsule_rig_dataset(num_models=2, **KW)
    return (lambda: RigStage(arch="jointnet", num_embed_sample=32),
            lambda rng, train: tr.epoch_batches(rng, 2, train, device="cpu"),
            tscan.rig_scan_batcher(tr, 2, device="cpu"), 2, 1)


def _bone_case():
    sample = tskel.capsule_skel_dataset(num_models=2, max_joints=8, device="cpu", **KW)

    def loop(rng, train):
        yield sample

    return BoneStage, loop, tscan.const_scan_batcher(sample), 4, 3


@pytest.mark.parametrize("case", ["corr", "rig", "bone"])
def test_scanned_matches_the_loop(tmp_path, case):
    """run_epochs and run_epochs_scanned from the same weights, generator
    and schedule draws: parameters and buffers equal, the best epoch equal,
    the logged metrics within LOG_RTOL, the same checkpoint files, and
    `epoch_wall_s` in the scanned log."""
    make, loop, batcher, epochs, chunk = {"corr": _corr_case, "rig": _rig_case,
                                          "bone": _bone_case}[case]()
    out = {}
    for runner in ("loop", "scan"):
        stage = make()
        state = stage.init_state(0, device="cpu")
        d = str(tmp_path / runner)
        logger = ttrainer.MetricLogger(d)
        rng_np, gen = np.random.default_rng(7), torch.Generator().manual_seed(3)
        if runner == "loop":
            state, best = ttrainer.run_epochs(stage, state, lambda e: loop(rng_np, True),
                                              lambda: loop(rng_np, False), None, epochs,
                                              checkpoint_dir=d, logger=logger, generator=gen)
        else:
            stats = {}
            state, best = tscan.run_epochs_scanned(stage, state, batcher, epochs=epochs,
                                                   checkpoint_dir=d, logger=logger, generator=gen,
                                                   rng_np=rng_np, chunk_epochs=chunk,
                                                   stats=stats)
            assert stats["fetches"] == stats["chunks"] and stats["captures"] == 0
        logger.close()
        out[runner] = (_read_log(d), [t.clone() for t in (*state.model.parameters(),
                                                          *state.model.buffers())], best,
                       sorted(os.listdir(d)), state.step)
    (la, wa, ba, fa, sa), (lb, wb, bb, fb, sb) = out["loop"], out["scan"]
    assert ba == bb and fa == fb and sa == sb
    assert all(torch.equal(x, y) for x, y in zip(wa, wb))
    assert set(la) == set(lb) and len(la) == 2 * epochs
    for key in la:
        assert set(la[key]) == set(lb[key])
        for k, v in la[key].items():
            assert abs(v - lb[key][k]) <= LOG_RTOL * abs(v), (key, k, v, lb[key][k])
    with open(tmp_path / "scan" / "metrics.jsonl") as f:
        assert all("epoch_wall_s" in json.loads(line) for line in f)


def test_model_best_holds_the_best_weights(tmp_path):
    """model_best.pt holds the best epoch's parameters (the loop's
    model_best of that epoch) with the chunk-end optimizer state, and its
    metadata the best epoch + 1 and the lowest loss."""
    make, loop, batcher, epochs, _ = _bone_case()
    got = {}
    for runner, chunk in (("loop", None), ("scan", epochs)):
        stage = make()
        state = stage.init_state(0, device="cpu")
        d = str(tmp_path / runner)
        rng_np, gen = np.random.default_rng(7), torch.Generator().manual_seed(3)
        if chunk is None:
            _, best = ttrainer.run_epochs(stage, state, lambda e: loop(rng_np, True),
                                          lambda: loop(rng_np, False), None, epochs,
                                          checkpoint_dir=d, generator=gen)
        else:
            _, best = tscan.run_epochs_scanned(stage, state, batcher, epochs=epochs,
                                               checkpoint_dir=d, generator=gen, rng_np=rng_np,
                                               chunk_epochs=chunk)
        saved = torch.load(os.path.join(d, "model_best.pt"), weights_only=True)
        with open(os.path.join(d, "model_best.pt.json")) as f:
            got[runner] = (saved, json.load(f), best, state)
    (ls, lm, lbest, _), (ss, sm, sbest, sstate) = got["loop"], got["scan"]
    assert lbest == sbest and lm == sm and sm["epoch"] == sbest + 1
    assert all(torch.equal(ls["model"][k], ss["model"][k]) for k in ls["model"])
    assert ss["step"] == sstate.step
    assert ss["optimizer"]["state"][0]["step"] == sstate.tx.optimizer.state_dict()["state"][0]["step"]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

CHUNK_GRID = list(itertools.product((0, 3), (1, 6, 10), (1, 2, 4, 25), (None, 0, 2, 5, 10)))


@pytest.mark.parametrize("start,epochs,chunk,boundary", CHUNK_GRID[::4] + CHUNK_GRID[1::9])
def test_chunk_ranges_match_jax(start, epochs, chunk, boundary):
    assert tscan._chunk_ranges(start, epochs, chunk, boundary) == \
        jscan._chunk_ranges(start, epochs, chunk, boundary)


def _assert_fields_equal(ref, got, path=""):
    """Every array of a JAX batch equal to the port's (indices by value)."""
    if dataclasses.is_dataclass(got) and not torch.is_tensor(got):
        names = MESH_KEYS if hasattr(got, "tpl_nbr") else [f.name for f in dataclasses.fields(got)]
        for n in names:
            _assert_fields_equal(getattr(ref, n), getattr(got, n), f"{path}.{n}")
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=path)


def _sched_rows(sched: dict, k: int, jax_side: bool) -> dict:
    """Row k of a schedule: JAX's src/tar are scalars, the port's (1,)."""
    if jax_side:
        return {n: jnp.asarray(v[k]).reshape(-1)[0] if n in ("src", "tar") else jnp.asarray(v[k])
                for n, v in sched.items()}
    return {n: torch.as_tensor(v[k]) for n, v in sched.items()}


@pytest.mark.parametrize("kind", ["pose", "pose_val", "rig", "rig_val", "const"])
def test_batcher_gathers_match_jax(kind):
    """One epoch's schedule from the same numpy draws: the same rows
    (steps per epoch, validation rows), and each row's gather equals JAX's,
    field by field; also the validation gathers."""
    if kind.startswith("pose"):
        jds = jpose.capsule_pose_dataset(num_models=3, num_frames=4, **KW)
        tds = tpose.capsule_pose_dataset(num_models=3, num_frames=4, **KW)
        jb = jscan.pose_scan_batcher(jds, 2, "modelsresource", False)
        tb = tscan.pose_scan_batcher(tds, 2, "modelsresource", False, device="cpu")
        if kind == "pose_val":
            jv = jpose.capsule_pose_dataset(num_models=2, num_frames=4, seed=9, **KW)
            tv = tpose.capsule_pose_dataset(num_models=2, num_frames=4, seed=9, **KW)
            jb = jscan.with_val_dataset(jb, jscan.pose_scan_batcher(jv, 2, "modelsresource",
                                                                    False))
            tb = tscan.with_val_dataset(tb, tscan.pose_scan_batcher(tv, 2, "modelsresource",
                                                                    False, device="cpu"))
    elif kind.startswith("rig"):
        jds, tds = (m.capsule_rig_dataset(num_models=3, **KW) for m in (jrig, trig))
        jv = tv = None
        if kind == "rig_val":
            jv, tv = (m.capsule_rig_dataset(num_models=2, seed=5, **KW) for m in (jrig, trig))
        jb = jscan.rig_scan_batcher(jds, 2, val_ds=jv)
        tb = tscan.rig_scan_batcher(tds, 2, val_ds=tv, device="cpu")
    else:
        jb = jscan.const_scan_batcher(jskel.capsule_skel_dataset(num_models=2, max_joints=8,
                                                                 **KW))
        tb = tscan.const_scan_batcher(tskel.capsule_skel_dataset(num_models=2, max_joints=8,
                                                                 device="cpu", **KW))
    assert (tb.steps_per_epoch, tb.n_val) == (jb.steps_per_epoch, jb.n_val)
    jsched = jb.schedule(0, np.random.default_rng(11))
    tsched = tb.schedule(0, np.random.default_rng(11))
    for n in jsched:
        np.testing.assert_array_equal(tsched[n].reshape(np.shape(jsched[n])), jsched[n])
    jval = getattr(jb, "val_gather", jb.gather)
    tval = tb.val_gather or tb.gather
    for gathers, scheds, rows in (((jb.gather, tb.gather), (jsched, tsched), tb.steps_per_epoch),
                                  ((jval, tval), (jb.val_scheds, tb.val_scheds), tb.n_val)):
        for k in range(rows):
            ref = gathers[0](_sched_rows(scheds[0], k, True))
            got = gathers[1](_sched_rows(scheds[1], k, False))
            _assert_fields_equal(ref, got, f"{kind} row {k}")


def test_metric_logger_records_match_jax(tmp_path):
    """The record layout of `MetricLogger.log` with `time_s` and extra
    fields, and without them, as the JAX package's."""
    lines = {}
    for side, cls in (("jax", jtrainer.MetricLogger), ("torch", ttrainer.MetricLogger)):
        logger = cls(str(tmp_path / side))
        logger.log(3, "train", {"loss": 1.5, "grad_norm": 2.0}, time_s=12.5, epoch_wall_s=0.25)
        logger.log(3, "val", {"loss": 1.25})
        logger.close()
        with open(tmp_path / side / "metrics.jsonl") as f:
            lines[side] = [json.loads(line) for line in f]
    assert [list(r) for r in lines["torch"]] == [list(r) for r in lines["jax"]]
    assert lines["torch"][0] == lines["jax"][0]
    assert {k: v for k, v in lines["torch"][1].items() if k != "time"} == \
        {k: v for k, v in lines["jax"][1].items() if k != "time"}


class _JaxCounter:
    """JAX side of a one-parameter stage: each train step adds 1 to w, the
    val total loss is TABLE[w]."""

    def __init__(self, table):
        self.table = jnp.asarray(table, jnp.float32)

    def on_epoch(self, epoch):
        pass

    def init_state(self):
        tx = optax.sgd(0.0)
        params = {"w": jnp.zeros((), jnp.float32)}
        return jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                                   opt_state=tx.init(params), tx=tx, apply_fn=None)

    def train_step(self, state, batch, rng):
        w = state.params["w"] + 1.0
        return state.replace(step=state.step + 1, params={"w": w}), {"loss": w}

    def eval_step(self, state, batch):
        return {"total_loss": self.table[state.params["w"].astype(jnp.int32)]}


class _TorchCounter:
    """The port's side of `_JaxCounter`."""

    def __init__(self, table):
        self.table = torch.tensor(table, dtype=torch.float32)

    def on_epoch(self, epoch):
        pass

    def init_state(self):
        model = torch.nn.Module()
        model.w = torch.nn.Parameter(torch.zeros(()))
        return ttrainer.TrainState(model, ttrainer.multistep_adam(model.parameters(), 0.0, (),
                                                                  1.0, 0.0))

    def train_step(self, state, batch, generator=None, on_device=False):
        with torch.no_grad():
            state.model.w.add_(1.0)
        state.step += 1
        m = {"loss": state.model.w.detach().clone()}
        return m if on_device else {k: float(v) for k, v in m.items()}

    def eval_step(self, state, batch, on_device=False):
        v = self.table[state.model.w.detach().long()]
        return {"total_loss": v} if on_device else {"total_loss": float(v)}


def _counter_runs(tmp_path, table, runners, tag, **kw):
    """Each runner ("jax loop", "jax scan", "torch loop", "torch scan") on a
    fresh counter stage with `kw`; returns {runner: (best epoch, the log by
    (epoch, split), the checkpoint files' metadata)}.  kw "resume": (epochs
    of a first segment) — a first segment from epoch 0, then a second one
    from its end, passing its model_best metadata as init_lowest /
    init_best_epoch (as tools/campaign.py does)."""
    out = {}
    for runner in runners:
        side, mode = runner.split()
        jax_side = side == "jax"
        stage = (_JaxCounter if jax_side else _TorchCounter)(table)
        state = stage.init_state()
        d = str(tmp_path / f"{tag} {runner}")
        logger = (jtrainer if jax_side else ttrainer).MetricLogger(d)
        segments = [(0, kw["resume"]), (kw["resume"], kw["epochs"])] if "resume" in kw \
            else [(0, kw["epochs"])]
        best = -1
        for start, end in segments:
            init = {}
            if start:
                ext = "msgpack" if jax_side else "pt"
                with open(os.path.join(d, f"model_best.{ext}.json")) as f:
                    meta = json.load(f)
                init = dict(init_lowest=meta["lowest_loss"], init_best_epoch=int(meta["epoch"]) - 1)
            common = dict(checkpoint_dir=d, logger=logger, start_epoch=start)
            if mode == "loop":
                args = (stage, state, lambda e: iter([None]), lambda: iter([None]), None, end)
                state, best = (jtrainer.run_epochs(*args, **common, **init) if jax_side
                               else ttrainer.run_epochs(*args, **common, **init))
            else:
                scan = dict(epochs=end, chunk_epochs=kw["chunk"],
                            early_stop_patience=kw.get("patience"),
                            init_lowest=kw.get("init_lowest", float("inf")), **common)
                scan.update(init)
                if jax_side:
                    state, best = jscan.run_epochs_scanned(
                        stage, state, jscan.const_scan_batcher({"x": np.zeros(1, np.float32)}),
                        rng=jax.random.key(0), **scan)
                else:
                    state, best = tscan.run_epochs_scanned(
                        stage, state, tscan.const_scan_batcher({"x": torch.zeros(1)}), **scan)
        logger.close()
        meta = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".json"):
                with open(os.path.join(d, name)) as f:
                    meta[name.split(".")[0]] = json.load(f)
        out[runner] = (best, _read_log(d), meta)
    return out


@pytest.mark.parametrize("table,patience,chunk,expect_stop", [
    ([9.0] * 21, 3, 4, 4),                                         # never improves (init -inf)
    ([9.0, 5.0, 4.0, 3.0, 6.0, 7.0, 8.0, 9.0, 9.5, 9.7, 9.9], 2, 2, 6),
])
def test_early_stop_matches_jax(tmp_path, table, patience, chunk, expect_stop):
    """run_epochs_scanned with early_stop_patience stops at the chunk end
    JAX's does, with the same best epoch, logs and checkpoint metadata
    (tests/test_scanned_train.py `test_early_stop_patience`: with
    init_lowest=-inf nothing improves and the first chunk stops it)."""
    kw = dict(epochs=len(table) - 1, chunk=chunk, patience=patience)
    if expect_stop == 4:
        kw["init_lowest"] = float("-inf")
    runs = _counter_runs(tmp_path, table, ("jax scan", "torch scan"), "stop", **kw)
    (jbest, jlog, jmeta), (tbest, tlog, tmeta) = runs["jax scan"], runs["torch scan"]
    assert tbest == jbest and max(e for e, _ in tlog) == expect_stop
    assert tlog == jlog and tmeta == jmeta
    if expect_stop == 4:
        assert tbest == -1 and "model_best" not in tmeta


def test_resume_keeps_the_global_best_like_jax(tmp_path):
    """tests/test_resume_best_epoch.py's case on both packages' loop and
    scanned runners: a first segment improves to its best epoch, a resumed
    one whose val never beats it (init_lowest / init_best_epoch from
    model_best's metadata) reports that epoch and leaves model_best alone;
    logs and metadata equal JAX's."""
    table = [9.0, 5.0, 4.0, 4.5, 6.0]
    runs = _counter_runs(tmp_path, table, ("jax loop", "torch loop", "jax scan", "torch scan"),
                         "resume", epochs=4, resume=2, chunk=1)
    for mode in ("loop", "scan"):
        (jbest, jlog, jmeta), (tbest, tlog, tmeta) = runs[f"jax {mode}"], runs[f"torch {mode}"]
        assert tbest == jbest == 1, mode
        assert tlog == jlog, mode
        assert tmeta == jmeta, mode
        assert tmeta["model_best"] == {"epoch": 2.0, "lowest_loss": 4.0}, mode


def test_loop_resume_reports_best_epoch_without_improving():
    """The port's run_epochs with init_lowest / init_best_epoch: a resumed
    segment that never improves returns init_best_epoch (it returned -1
    before init_best_epoch existed)."""
    stage = _TorchCounter([9.0, 5.0, 4.0, 4.5, 6.0])
    state = stage.init_state()
    state.model.w.data.fill_(2.0)
    _, best = ttrainer.run_epochs(stage, state, lambda e: iter([None]), lambda: iter([None]),
                                  None, 4, start_epoch=2, init_lowest=4.0, init_best_epoch=1)
    assert best == 1


def test_root_stage_scanned_run_matches_jax(tmp_path):
    """A whole run_epochs_scanned of RootStage (no draws): 2 epochs in chunks
    of 1 on the capsule skeleton sample, from the same seeded weights on both
    sides (every parameter filled, the zero-initialized head included), JAX
    through its Pallas kernels in interpret mode with exact top-k.  The best
    epoch equal; the logged losses and gradient norms at NETWORK relative,
    root_acc equal; the final parameters within 2 lr per step (the skeleton
    step test's bound for one step, tests/test_torch_skel_train.py)."""
    import torch_port_fixtures as F
    from torch_port_fixtures import NETWORK

    from morig_tpu.kernels import neighbors as jnb
    from morig_tpu.train import stages as jstages
    from morig_tpu_torch import weights as W
    from morig_tpu_torch.train.stages import RootStage

    skel = dict(num_points=64, n_lat=9, n_lon=8)
    jb = jskel.capsule_skel_dataset(num_models=2, max_joints=8, **skel)
    tb = tskel.capsule_skel_dataset(num_models=2, max_joints=8, device="cpu", **skel)
    jstage, tstage = jstages.RootStage(), RootStage()
    epochs, lr = 2, 1e-3
    jnb.set_topk_mode("exact")
    try:
        with F.jax_fused_kernels(), F.jax_training_kernels():
            params = F.flax_params(jstage.model, 84, jb.mesh, jb.joints, jb.joints_mask)
            state = jstage.init_state(jax.random.key(0), jb)
            state = state.replace(params=params, opt_state=state.tx.init(params))
            jlogger = jtrainer.MetricLogger(str(tmp_path / "jax"))
            jstate, jbest = jscan.run_epochs_scanned(
                jstage, state, jscan.const_scan_batcher(jb), epochs=epochs, logger=jlogger,
                rng=jax.random.key(3), rng_np=np.random.default_rng(0), chunk_epochs=1)
            jlogger.close()
    finally:
        jnb.set_topk_mode("auto")
    tstate = tstage.init_state(device="cpu")
    tstate.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
    tlogger = ttrainer.MetricLogger(str(tmp_path / "torch"))
    tstate, tbest = tscan.run_epochs_scanned(tstage, tstate, tscan.const_scan_batcher(tb),
                                             epochs=epochs, logger=tlogger,
                                             generator=torch.Generator().manual_seed(3),
                                             rng_np=np.random.default_rng(0), chunk_epochs=1)
    tlogger.close()
    assert tbest == jbest
    jlog, tlog = _read_log(tmp_path / "jax"), _read_log(tmp_path / "torch")
    assert set(jlog) == set(tlog) and len(tlog) == 2 * epochs
    for key, ref in jlog.items():
        # the port's train steps also return the gradient norm
        assert set(tlog[key]) == set(ref) | ({"grad_norm"} if key[1] == "train" else set()), key
        for k, v in ref.items():
            if k == "root_acc":
                assert tlog[key][k] == v, (key, k)
            else:
                assert abs(tlog[key][k] - v) <= NETWORK[0] * abs(v), (key, k, tlog[key][k], v)
    jnew = W.flax_to_state_dict(jstate.params)
    for n, p in tstate.model.named_parameters():
        F.assert_close(p.detach(), jnew[n], atol=2 * lr * epochs, rtol=1e-6, what=n)


def test_checkpoint_load_conforms_the_optimizer_form(tmp_path):
    """A checkpoint whose optimizer is in the card's form (a tensor learning
    rate, capturable) loads into a CPU state in the CPU's form (a float
    rate, not capturable), with its schedule, and the state trains on."""
    from morig_tpu_torch.train import checkpoint as ckpt

    make, loop, _, _, _ = _bone_case()
    stage = make()
    state = stage.init_state(0, device="cpu")
    batch = next(loop(None, True))
    stage.train_step(state, batch, torch.Generator().manual_seed(0))
    path = ckpt.save_checkpoint(state, str(tmp_path))
    saved = torch.load(path, weights_only=True)
    for group in saved["optimizer"]["param_groups"]:
        group["lr"], group["capturable"] = torch.tensor(group["lr"]), True
    torch.save(saved, path)
    fresh = make().init_state(1, device="cpu")
    fresh, _ = ckpt.load_checkpoint(fresh, path)
    group = fresh.tx.optimizer.param_groups[0]
    # the card's rate is an fp32 tensor: 1e-3 rounded to fp32
    assert not torch.is_tensor(group["lr"]) and group["lr"] == float(torch.tensor(1e-3))
    assert not group["capturable"]
    assert fresh.step == 1 and fresh.tx.scheduler.last_epoch == 1
    m = stage.train_step(fresh, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(m["total_loss"]) and fresh.step == 2
