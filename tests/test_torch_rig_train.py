"""The port's RigStage (jointnet and masknet), SkinStage and rig datasets
against the JAX package, on the CPU.

The datasets are held array for array; one train step of each stage is held
whole against JAX (its Pallas edge kernels in interpret mode,
`jax_training_kernels`), with the embedding loss fed the indices JAX drew;
the modules under these steps are held one by one in
test_torch_deform_train.py.  Small size: capsules (n_lat=7, n_lon=6, V=38
padded to 128, degree-12 tables), T=2 keyframes.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morig_tpu.core.config import DEFAULT_CONFIG
from morig_tpu.data import creature as jcreature
from morig_tpu.data import rig as jrig
from morig_tpu.nn import rignet as jrn
from morig_tpu.train import stages as jstages
from morig_tpu_torch import weights as W
from morig_tpu_torch.core import config as tcfg
from morig_tpu_torch.data import creature as tcreature
from morig_tpu_torch.data import rig as trig
from morig_tpu_torch.kernels import edge_fused as tef
from morig_tpu_torch.losses import nce as tnce
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.nn import rignet as trn
from morig_tpu_torch.train import checkpoint as tckpt
from morig_tpu_torch.train import stages as tstages
from morig_tpu_torch.train import trainer as ttrainer

import torch_port_fixtures as F
from torch_port_fixtures import (NETWORK, STEP_GRAD, STEP_GRAD_TOTAL, assert_close,
                                 assert_rel_close)

T_KEY = 2
NUM_SAMPLE = 64          # anchors per sample: more than a capsule's 38 vertices
RIG_DATA = dict(n_lat=7, n_lon=6, num_points=128, num_keyframes=T_KEY)
JCFG = dataclasses.replace(DEFAULT_CONFIG, model=dataclasses.replace(
    DEFAULT_CONFIG.model, num_keyframes=T_KEY))
TCFG = dataclasses.replace(tcfg.DEFAULT_CONFIG, model=dataclasses.replace(
    tcfg.DEFAULT_CONFIG.model, num_keyframes=T_KEY))


def _rig_datasets(pad_verts: int = 128):
    jds = jrig.capsule_rig_dataset(2, **RIG_DATA)
    tds = trig.capsule_rig_dataset(2, **RIG_DATA)
    kw = dict(pad_verts=pad_verts, tpl_max_degree=12, geo_max_degree=12)
    return jrig.RigDataset(jds.models, **kw), trig.RigDataset(tds.models, **kw)


def _assert_batches_equal(jb, tb):
    for f in dataclasses.fields(tb):
        jx, tx = getattr(jb, f.name), getattr(tb, f.name)
        if f.name == "mesh":
            for k in ("verts", "vert_mask", "tpl_nbr", "tpl_mask", "geo_nbr", "geo_mask"):
                np.testing.assert_array_equal(getattr(tx, k).numpy(), np.asarray(getattr(jx, k)),
                                              err_msg=k)
        else:
            assert tx.device.type == "cpu"
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx), err_msg=f.name)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["capsule", "creature"])
def test_rig_dataset_batches_match_jax(kind):
    """capsule_rig_dataset and creature_rig_dataset (euclidean skin
    distances, a few hundred vertices) build the same models as the JAX
    package's, and RigDataset.batch gives the same arrays bit for bit, the
    K-nearest-bone descriptors included (after RigSample.to); the epoch
    schedules agree draw for draw."""
    if kind == "capsule":
        jds = jrig.capsule_rig_dataset(3, seed=1, **RIG_DATA)
        tds = trig.capsule_rig_dataset(3, seed=1, **RIG_DATA)
    else:
        kw = dict(num_models=3, seed=2, num_keyframes=T_KEY, num_points=128, target_verts=300)
        jds, tds = jcreature.creature_rig_dataset(**kw), tcreature.creature_rig_dataset(**kw)
    assert tds.pad_verts == jds.pad_verts
    _assert_batches_equal(jds.batch([0, 2]), tds.batch([0, 2], device="cpu").to("cpu"))
    for train in (True, False):
        js = jds.epoch_schedule(np.random.default_rng(4), 2, train)
        assert tds.epoch_schedule(np.random.default_rng(4), 2, train) == js


def test_volumetric_creature_rig_dataset_matches_jax():
    """creature_rig_dataset(use_volumetric_geo=True) (each side its own
    voxels and surface geodesics) gives JAX's batch: the descriptors of the
    K nearest bones by volumetric geodesic within 1e-5 relative, every other
    array equal."""
    kw = dict(num_models=1, seed=5, num_keyframes=2, num_points=64, target_verts=300,
              use_volumetric_geo=True)
    jds = jcreature.creature_rig_dataset(**kw)
    tds = tcreature.creature_rig_dataset(device="cpu", **kw)
    jb, tb = jds.batch([0]), tds.batch([0], device="cpu")
    for f in dataclasses.fields(tb):
        if f.name == "mesh":
            continue
        got, ref = getattr(tb, f.name), np.asarray(getattr(jb, f.name))
        if f.name == "skin_input":
            assert_close(got, ref, atol=1e-6, rtol=1e-5, what=f.name)
        else:
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f.name)
    euclid = tcreature.creature_rig_dataset(device="cpu", **dict(kw, use_volumetric_geo=False))
    assert not np.array_equal(euclid.models[0].skin_input, tds.models[0].skin_input)


# ---------------------------------------------------------------------------
# width_scale
# ---------------------------------------------------------------------------

def test_jointnet_width_scale_forward_matches_flax():
    """JointNetMotion at width_scale=0.25 (the JAX width rule max(8, int(c *
    s))): the same parameter shapes as flax's, the forward at NETWORK; its
    8-wide edge layers, which the kernels do not take, run the counted plain
    route, the others K1 (its plain version on the CPU)."""
    jds, tds = _rig_datasets()
    jb, tb = jds.batch([0, 1]), tds.batch([0, 1], device="cpu")
    m = jrn.JointNetMotion(num_keyframes=T_KEY, width_scale=0.25)
    p = F.flax_params(m, 61, jb.gt_flow, jb.mesh)
    with F.jax_fused_kernels():
        ref = m.apply({"params": p}, jb.gt_flow, jb.mesh)
    net = F.bridged(lambda: trn.JointNetMotion(T_KEY, width_scale=0.25), W.flax_to_state_dict(p))
    edges = [mod for mod in net.modules() if isinstance(mod, tgcu.EdgeMLP)]
    plain = sum(not mod.kernel_route for mod in edges)
    assert plain == 4 and len(edges) == 24       # the x layers of both GCNRigs' gcu_1
    before = tgcu.plain_edge.launches
    with torch.no_grad():
        got = net(tb.gt_flow, tb.mesh)
    # the motion trunk runs once per keyframe, the head once
    assert tgcu.plain_edge.launches - before == 2 * (T_KEY + 1)
    vm = np.asarray(jb.mesh.vert_mask)
    for g, r, what in zip(got, ref, ("motion_all", "motion_aggr", "shift")):
        assert_rel_close(g, r, NETWORK, vm, what)


# ---------------------------------------------------------------------------
# one step of each stage
# ---------------------------------------------------------------------------

STAGES = ("jointnet", "masknet", "skin")


def _stages(kind):
    if kind == "skin":
        return (jstages.SkinStage(JCFG, num_embed_sample=NUM_SAMPLE),
                tstages.SkinStage(TCFG, num_embed_sample=NUM_SAMPLE))
    return (jstages.RigStage(JCFG, kind, num_embed_sample=NUM_SAMPLE),
            tstages.RigStage(TCFG, kind, num_embed_sample=NUM_SAMPLE))


def _inputs(kind, b, flow):
    return (b.skin_input, flow, b.mesh) if kind == "skin" else (flow, b.mesh)


@pytest.fixture(scope="module", params=STAGES)
def rig_step(request):
    return _rig_step(request.param)


def _rig_step(kind):
    """One train step on both sides from the same seeded weights (heads
    included) and batch.  pred_flow is set to gt_flow on both sides, so the
    50/50 flow draw does not matter, and the port's embedding loss replays
    the anchors, positives and negatives JAX draws from its key."""
    jds, tds = _rig_datasets()
    jb, tb = jds.batch([0, 1]), tds.batch([0, 1], device="cpu")
    jb = dataclasses.replace(jb, pred_flow=jb.gt_flow)
    tb = dataclasses.replace(tb, pred_flow=tb.gt_flow)
    jstage, stage = _stages(kind)
    key = jax.random.key(11)
    with F.jax_training_kernels():
        params = F.flax_params(jstage.model, 71, *_inputs(kind, jb, jb.gt_flow), True)

        def loss_fn(p):
            out = jstage.model.apply({"params": p}, *_inputs(kind, jb, jb.gt_flow), True)
            return jstage._losses(key, out, jb)

        (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jstage.make_tx()
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = W.flax_to_state_dict(optax.apply_updates(params, updates))

    draws = [tuple(torch.as_tensor(d) for d in F.jax_multi_pos_draws(
        k, jb.gt_skin, jb.mesh.vert_mask, NUM_SAMPLE)) for k in jax.random.split(key, T_KEY + 1)]
    replay = itertools.cycle(draws)

    def replayed(generator, feature, gt_skin, vert_mask, num_sample):
        assert num_sample == NUM_SAMPLE
        return tnce.multi_pos_info_nce_drawn(feature, gt_skin, vert_mask, *next(replay))

    state = stage.init_state(device="cpu")
    state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstages, "multi_pos_info_nce", replayed)
        gen = torch.Generator().manual_seed(0)
        outputs = stage._forward(state.model, tb, tb.gt_flow, True)
        stage._losses(gen, outputs, tb)[0].backward()
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        before = (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches,
                  tgcu.plain_edge.launches)
        metrics = stage.train_step(state, tb, gen)
        assert before == (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches,
                          tgcu.plain_edge.launches)
    return dict(kind=kind, jmetrics=jmetrics, jgrads=W.flax_to_state_dict(jgrads), jnew=jnew,
                metrics=metrics, grads=grads, state=state, stage=stage, batch=tb)


def test_rig_step_losses_match_jax(rig_step):
    """Every loss of the step at NETWORK (the outputs pass 36 edge layers)."""
    assert set(rig_step["jmetrics"]) | {"grad_norm"} == set(rig_step["metrics"])
    for k, ref in rig_step["jmetrics"].items():
        assert abs(rig_step["metrics"][k] - float(ref)) <= NETWORK[0] * abs(float(ref)), (k, ref)
    assert np.isfinite(rig_step["metrics"]["grad_norm"])


def test_rig_step_grads_match_jax(rig_step):
    """Every parameter's gradient (before the clip) at STEP_GRAD and the
    whole gradient vector at STEP_GRAD_TOTAL relative L2
    (torch_port_fixtures states both with the measured errors)."""
    grads, ref = rig_step["grads"], rig_step["jgrads"]
    assert set(grads) == set(ref)
    for n, g in grads.items():
        assert_rel_close(g, ref[n], STEP_GRAD, what=n)
    flat = np.concatenate([F.np_(grads[n]).ravel() for n in grads])
    flat_ref = np.concatenate([np.asarray(ref[n]).ravel() for n in grads])
    assert np.linalg.norm(flat - flat_ref) <= STEP_GRAD_TOTAL * np.linalg.norm(flat_ref)


def test_rig_step_update_matches_jax(rig_step):
    """Parameters after the step within 2 lr (5e-4) of JAX's, up to the
    rounding of p +- lr (Adam's first step is lr * sign(g))."""
    for n, p in rig_step["state"].model.named_parameters():
        assert_close(p.detach(), rig_step["jnew"][n], atol=2 * 5e-4, rtol=1e-6, what=n)


def test_rig_steps_lower_the_loss(rig_step):
    """Four more CPU steps (the port's own draws now) lower the total loss
    on the batch; eval_step with a fixed generator is deterministic and
    infer runs the inference forward."""
    stage, state, batch = rig_step["stage"], rig_step["state"], rig_step["batch"]
    ev = lambda: stage.eval_step(state, batch, torch.Generator().manual_seed(3))
    first = ev()
    assert first == ev()
    g = torch.Generator().manual_seed(1)
    for _ in range(4):
        stage.train_step(state, batch, g)
    assert ev()["total_loss"] < first["total_loss"], (first, ev())
    out = stage.infer(state, *_inputs(rig_step["kind"], batch, batch.pred_flow))
    width = {"jointnet": 3, "masknet": 1, "skin": 5}[rig_step["kind"]]
    assert out[2].shape == (2, 128, width) and not out[2].requires_grad


def test_run_epochs_trains_and_checkpoints_rig_stage(tmp_path):
    """RigStage through the epoch loop for 2 epochs (one training and one
    validation batch each, at width_scale 0.25), a checkpoint and a best
    copy that loads back into a fresh state."""
    _, tds = _rig_datasets()
    stage = tstages.RigStage(TCFG, num_embed_sample=NUM_SAMPLE, width_scale=0.25)
    state = stage.init_state(device="cpu")
    state, best = ttrainer.run_epochs(
        stage, state,
        lambda epoch: tds.epoch_batches(np.random.default_rng(epoch), 2, device="cpu"),
        lambda: tds.epoch_batches(np.random.default_rng(0), 2, train=False, device="cpu"),
        None, epochs=2, checkpoint_dir=str(tmp_path), generator=torch.Generator().manual_seed(2))
    assert state.step == 2 and best in (0, 1)
    fresh, meta = tckpt.load_checkpoint(stage.init_state(seed=5, device="cpu"),
                                        str(tmp_path / "checkpoint.pt"))
    assert fresh.step == 2 and meta["epoch"] == 2.0
    for (n, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n
    assert (tmp_path / "model_best.pt").exists()
