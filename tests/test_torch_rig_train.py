"""The port's RigStage (jointnet and masknet), SkinStage and rig datasets
against the JAX package, on the CPU.

The datasets are held array for array; one train step of each stage is held
whole against JAX (its Pallas edge kernels in interpret mode,
`jax_training_kernels`), with the embedding loss fed the indices JAX drew;
the modules under these steps are held one by one in
test_torch_deform_train.py.  Small size: capsules (n_lat=7, n_lon=6, V=38
padded to 128, degree-12 tables), T=2 keyframes.
"""
import copy
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
from morig_tpu.train import trainer as jtrainer
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
from flax.traverse_util import flatten_dict, unflatten_dict
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
    updates, opt1 = tx.update(jgrads, tx.init(params), params)
    jstate = _jax_state(jstage, optax.apply_updates(params, updates), opt1, step=1)
    jnew = W.flax_to_state_dict(jstate.params)

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
                metrics=metrics, grads=grads, state=state, stage=stage, batch=tb,
                jstage=jstage, jstate=jstate, jbatch=jb, jparams0=params)


def _jax_state(jstage, params, opt_state=None, step: int = 0):
    """The JAX package's TrainState over `params` (the state `init_state`
    builds, without its init), at `step` with `opt_state` when given."""
    tx = jstage.make_tx()
    return jtrainer.TrainState(step=jnp.asarray(step, jnp.int32), params=params, batch_stats={},
                               opt_state=tx.init(params) if opt_state is None else opt_state,
                               tx=tx, apply_fn=jstage.model.apply)


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


def _replaying(jb, key):
    """A context in which the port's embedding loss takes the draws the JAX
    package's takes from `key` (split into T + 1 keys, one per call)."""
    draws = [tuple(torch.as_tensor(d) for d in F.jax_multi_pos_draws(
        k, jb.gt_skin, jb.mesh.vert_mask, NUM_SAMPLE)) for k in jax.random.split(key, T_KEY + 1)]

    def replayed(generator, feature, gt_skin, vert_mask, num_sample):
        return tnce.multi_pos_info_nce_drawn(feature, gt_skin, vert_mask, *draws.pop(0))

    mp = pytest.MonkeyPatch()
    mp.setattr(tstages, "multi_pos_info_nce", replayed)
    return mp


def _adam_state(jstate):
    """The ScaleByAdamState (count, mu, nu) of a JAX TrainState's optax chain."""
    found = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


def _load_jax_state(state, jstate):
    """The port's parameters and Adam moments set to those of the JAX
    TrainState `jstate` (both at the same step count)."""
    params = W.flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    adam = _adam_state(jstate)
    mu = W.flax_to_state_dict(jax.tree.map(np.asarray, adam.mu))
    nu = W.flax_to_state_dict(jax.tree.map(np.asarray, adam.nu))
    opt = state.tx.optimizer
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(torch.as_tensor(params[n]))
            st = opt.state[p]
            st["exp_avg"].copy_(torch.as_tensor(mu[n]))
            st["exp_avg_sq"].copy_(torch.as_tensor(nu[n]))


# Adam's first step moves every entry by lr * sign(g), g the clipped,
# decayed gradient: a step in g at 0.  Where the two sides' g lie on either
# side of 0 (g within its rounding noise of 0: the bf16 layers' gradients
# differ by STEP_GRAD) the two states after one step are 2 lr apart
# (test_rig_step_update_matches_jax), which moves the later losses by more
# than the port's error (masknet's first eval loss_bce 1.1% to 5.6% from
# JAX's when only the summation order of a LayerNorm's mean changed).  The
# own-state check below takes those entries, on both sides, as if their g
# were exactly 0: the parameter stays at its initial value and both moments
# are 0; their share of the entries is bounded by SIGN_FLIP_FRAC (measured
# 1.8% masknet, 3.3% jointnet, 3.4% skin).
SIGN_FLIP_FRAC = 0.05


def _flax_names(tree):
    """{state-dict name: (flax key path, whether the leaf is a Dense kernel,
    the transpose of its weight)}, W.flax_to_state_dict's naming."""
    names = {}
    for keys in flatten_dict(tree):
        *path, leaf = keys
        names[".".join([*path, "weight" if leaf in ("kernel", "scale") else leaf])] = (
            keys, leaf == "kernel")
    assert set(names) == set(W.flax_to_state_dict(tree))
    return names


def _first_step_sign_flips(state, jstate):
    """{parameter name: bool tensor}: the entries whose first Adam step took
    the other sign on the port than in JAX (the signs of the first moments)."""
    mu = W.flax_to_state_dict(jax.tree.map(np.asarray, _adam_state(jstate).mu))
    opt = state.tx.optimizer
    return {n: torch.sign(opt.state[p]["exp_avg"]) != torch.sign(torch.as_tensor(mu[n]))
            for n, p in state.model.named_parameters()}


def _unstep_flips(state, jstate, flips, jparams0):
    """Both states with the `flips` entries as after a first step on g = 0:
    the initial parameter (`jparams0`, the flax tree both sides started
    from) and zero moments.  Edits the port's state in place; returns the
    JAX one."""
    p0 = W.flax_to_state_dict(jax.tree.map(np.asarray, jparams0))
    opt = state.tx.optimizer
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            f = flips[n]
            p[f] = p0[n][f]
            opt.state[p]["exp_avg"][f] = 0.0
            opt.state[p]["exp_avg_sq"][f] = 0.0
    masks = {keys: np.asarray(flips[n]).T if kernel else np.asarray(flips[n])
             for n, (keys, kernel) in _flax_names(jstate.params).items()}

    def edit(tree, fill):
        flat = flatten_dict(tree)
        return type(tree)(unflatten_dict({k: jnp.where(masks[k], fill(k), v)
                                          for k, v in flat.items()}))

    flat0 = flatten_dict(jparams0)
    adam = lambda s: (s._replace(mu=edit(s.mu, lambda k: 0.0), nu=edit(s.nu, lambda k: 0.0))
                      if hasattr(s, "mu") else s)
    return jstate.replace(params=edit(jstate.params, lambda k: flat0[k]),
                          opt_state=jax.tree_util.tree_map(adam, jstate.opt_state,
                                                           is_leaf=lambda x: hasattr(x, "mu")))


def _steps_against_jax(rig_step, state, jstate, start: str, direction: bool = True):
    """Eval, four train steps and eval on both sides from `state` / `jstate`,
    each taking JAX's draws: every eval loss within NETWORK of JAX's (for
    skin the first eval's only); with `direction`, the total moving the same
    way on both sides and falling for masknet and skin."""
    stage, batch = rig_step["stage"], rig_step["batch"]
    jstage, jb = rig_step["jstage"], rig_step["jbatch"]
    ev = lambda: stage.eval_step(state, batch, torch.Generator().manual_seed(3))
    assert ev() == ev()

    def evals():
        mp = _replaying(jb, jax.random.key(3))
        try:
            got = ev()
        finally:
            mp.undo()
        with F.jax_training_kernels():
            ref = jstage.eval_step(jstate, jb, jax.random.key(3))
        return got, {k: float(v) for k, v in ref.items()}

    first, jfirst = evals()
    for i in range(4):
        rng = jax.random.key(40 + i)
        mp = _replaying(jb, jax.random.split(rng)[1])
        try:
            stage.train_step(state, batch, torch.Generator().manual_seed(i))
        finally:
            mp.undo()
        with F.jax_training_kernels():
            jstate, _ = jstage.train_step(jstate, jb, rng)
    last, jlast = evals()
    print(f"{rig_step['kind']} eval from the {start}, port | JAX: {first} -> {last} | "
          f"{jfirst} -> {jlast}")
    for got, ref in ((first, jfirst), (last, jlast)):
        assert set(got) == set(ref), (got, ref)
        if rig_step["kind"] == "skin" and got is last:
            continue
        for k, v in ref.items():
            assert abs(got[k] - v) <= NETWORK[0] * abs(v), (start, k, got, ref)
    if not direction:
        return
    loss = lambda m: m["total_loss"]
    assert (loss(last) < loss(first)) == (loss(jlast) < loss(jfirst)), (start, first, last,
                                                                        jfirst, jlast)
    if rig_step["kind"] != "jointnet":
        assert loss(last) < loss(first), (start, first, last)


def test_rig_steps_lower_the_loss(rig_step):
    """Four more CPU steps, each taking JAX's draws, as four more steps of
    the JAX package (eval taking JAX's draws too), twice.  From the two
    sides' own states after the fixture's step, the entries whose first
    Adam step took the sign of rounding noise (SIGN_FLIP_FRAC) as on g = 0
    on both sides: for jointnet and masknet every eval loss before and
    after within NETWORK of JAX's, the total moving the same way on both
    sides and falling for masknet; for skin the eval before.  From one
    shared start, JAX's state after that step (its parameters and Adam
    moments loaded into the port): the same, and skin's total moving as
    JAX's and falling.  Measured (port | JAX), own states: jointnet total
    4.12045 -> 4.12814 | 4.11998 -> 4.12937, every loss within 0.08%;
    masknet 1.58849 -> 1.52770 | 1.58849 -> 1.52653, loss_bce within 1.3%;
    skin 0.56082 | 0.56364 before (loss_skin within 0.7%), then 0.56422 |
    0.44820.  Shared start: jointnet 4.12138 -> 4.13348 | 4.12102 ->
    4.13373, every loss within 0.03%; masknet 1.58840 -> 1.53338 | 1.58840
    -> 1.53334, loss_bce within 0.4%; skin 0.55679 -> 0.37133 | 0.55778 ->
    0.44088.  Skin's later values, and from its own state its direction,
    are not held: its motion head starts at zero, where the motion loss's
    gradient is rounding noise lifted by l2_normalize
    (test_skin_motion_gradient_at_the_collapsed_start_is_rounding_noise),
    which Adam turns into steps of lr on both sides, so its four steps
    are a draw (here the port's total rises where JAX's falls; from the
    shared start both fall, to 0.371 and 0.441);
    test_skin_steps_match_jax_with_its_draws holds skin's values from a
    filled head.  eval_step with a fixed generator is deterministic and
    infer runs the inference forward."""
    state, jstate = rig_step["state"], rig_step["jstate"]
    shared = copy.deepcopy(state)
    _load_jax_state(shared, jstate)
    # (the JAX train step donates its state's buffers)
    _steps_against_jax(rig_step, shared, jax.tree.map(jnp.copy, jstate), "shared start")
    flips = _first_step_sign_flips(state, jstate)
    n, total = sum(int(f.sum()) for f in flips.values()), sum(f.numel() for f in flips.values())
    print(f"{rig_step['kind']}: {n} of {total} entries took the other sign in the first step")
    assert n <= SIGN_FLIP_FRAC * total, (n, total)
    jstate = _unstep_flips(state, jstate, flips, rig_step["jparams0"])
    _steps_against_jax(rig_step, state, jstate, "own states",
                       direction=rig_step["kind"] != "skin")
    batch = rig_step["batch"]
    out = rig_step["stage"].infer(state, *_inputs(rig_step["kind"], batch, batch.pred_flow))
    width = {"jointnet": 3, "masknet": 1, "skin": 5}[rig_step["kind"]]
    assert out[2].shape == (2, 128, width) and not out[2].requires_grad


SKIN_STEPS = 6
HEADS = ("motion.motionNet.mlp_transform.", "motion.aggregator.")


def test_skin_steps_match_jax_with_its_draws():
    """SkinStage for SKIN_STEPS Adam steps on both sides from the JAX
    package's own initial weights (its `init_state`), carried to the port,
    with the motion trunk's zero-initialized output layer filled from a
    seed (at the zero head the motion loss's gradient is rounding noise,
    see the next test), on a batch whose pred_flow is not its gt_flow.  Each step
    replays JAX's draws into the port: the 50/50 flow draw
    (morig_tpu/train/stages.py's SkinStage step; both flows drawn over the
    steps) and the embedding loss's anchors, positives and negatives (as
    `_rig_step`).  Each step's loss_motion and loss_skin at NETWORK, and
    after each step the motion head's and the temporal aggregator's
    parameters within 2 lr (5e-4) per step taken of JAX's, up to the
    rounding of p +- lr (the one-step bound of
    test_rig_step_update_matches_jax, per step as test_torch_scanned's
    RootStage run: Adam moves an entry whose gradient sits at the bf16
    layers' rounding level by up to lr a step, either way).  Measured:
    loss_motion within 9.8e-4 relative, loss_skin within 1.31e-2 (step 2),
    the head's entries within 0.993 of the bound (step 0) and 0.77 of it
    by step 5."""
    jds, tds = _rig_datasets()
    jb, tb = jds.batch([0, 1]), tds.batch([0, 1], device="cpu")
    assert not np.array_equal(np.asarray(jb.pred_flow), np.asarray(jb.gt_flow))
    jstage, stage = _stages("skin")
    params = jax.tree.map(np.asarray, jstage.init_state(jax.random.key(5), jb).params)
    fresh = F.flax_params(jstage.model, 73, *_inputs("skin", jb, jb.gt_flow), True)
    head = params["motion"]["motionNet"]["mlp_transform"]
    head["out"] = fresh["motion"]["motionNet"]["mlp_transform"]["out"]
    jstate = _jax_state(jstage, params)
    state = stage.init_state(device="cpu")
    state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
    flows, replay = [], []

    def input_flow(batch, generator):
        return batch.gt_flow if flows[-1] else batch.pred_flow

    def replayed(generator, feature, gt_skin, vert_mask, num_sample):
        return tnce.multi_pos_info_nce_drawn(feature, gt_skin, vert_mask, *replay.pop(0))

    gen = torch.Generator().manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stage, "input_flow", input_flow)
        mp.setattr(tstages, "multi_pos_info_nce", replayed)
        for i in range(SKIN_STEPS):
            rng = jax.random.key(300 + i)
            k_flow, k_embed = jax.random.split(rng)
            flows.append(bool(jax.random.uniform(k_flow) > 0.5))
            replay[:] = [tuple(torch.as_tensor(d) for d in F.jax_multi_pos_draws(
                k, jb.gt_skin, jb.mesh.vert_mask, NUM_SAMPLE))
                for k in jax.random.split(k_embed, T_KEY + 1)]
            with F.jax_training_kernels():
                jstate, jm = jstage.train_step(jstate, jb, rng)
            m = stage.train_step(state, tb, gen)
            assert replay == []
            for k in ("loss_motion", "loss_skin"):
                ref = float(jm[k])
                assert abs(m[k] - ref) <= NETWORK[0] * abs(ref), (i, k, m[k], ref)
            jnew = W.flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
            for n, p in state.model.named_parameters():
                if n.startswith(HEADS):
                    assert_close(p.detach(), jnew[n], atol=2 * 5e-4 * (i + 1), rtol=1e-6,
                                 what=f"{i} {n}")
    assert set(flows) == {True, False}


def test_skin_motion_gradient_at_the_collapsed_start_is_rounding_noise():
    """At a fresh init (the JAX package's own `init_state`, carried to the
    port: the motion trunk's head zero) every keyframe's motion feature is
    l2_normalize's zero vector and the aggregate is one vector at every
    vertex (the CLS token's), where the multi-positive infoNCE's gradient
    cancels (each row's weights sum to 0 over equal features): on both
    sides the motion loss's gradient reaching the temporal aggregator is
    rounding noise, below 1e-8 of the largest skin-loss gradient, and
    l2_normalize's 1/sqrt(eps) = 1e6 at zero lifts it onto the zero head,
    whose gradient is 1e5 times larger; Adam's first step (lr x sign) then
    follows the rounding.  Measured: the head's gradient 2.1e-4 here, 1.6e-4
    in JAX, correlated -0.18 (JAX's Pallas and XLA paths: 1.000, one
    summation order); the aggregator's 4e-11 to 1.4e-10 on both sides."""
    jds, tds = _rig_datasets()
    jb, tb = jds.batch([0, 1]), tds.batch([0, 1], device="cpu")
    jstage, stage = _stages("skin")
    params = jax.tree.map(np.asarray, jstage.init_state(jax.random.key(5), jb).params)
    assert not params["motion"]["motionNet"]["mlp_transform"]["out"]["kernel"].any()
    key = jax.random.key(11)

    def jgrad(comp):
        def loss(p):
            out = jstage.model.apply({"params": p}, jb.skin_input, jb.pred_flow, jb.mesh, True)
            return jstage._losses(key, out, jb)[1][comp]
        with F.jax_training_kernels():
            g = jax.jit(jax.grad(loss))(params)
        return W.flax_to_state_dict(jax.tree.map(np.asarray, g))

    def tgrad(comp):
        draws = [tuple(torch.as_tensor(d) for d in F.jax_multi_pos_draws(
            k, jb.gt_skin, jb.mesh.vert_mask, NUM_SAMPLE)) for k in jax.random.split(key, T_KEY + 1)]

        def replayed(generator, feature, gt_skin, vert_mask, num_sample):
            return tnce.multi_pos_info_nce_drawn(feature, gt_skin, vert_mask, *draws.pop(0))

        state = stage.init_state(device="cpu")
        state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tstages, "multi_pos_info_nce", replayed)
            out = stage._forward(state.model, tb, tb.pred_flow, True)
            stage._losses(torch.Generator(), out, tb)[1][comp].backward()
        return {n: F.np_(p.grad) if p.grad is not None else np.zeros(tuple(p.shape))
                for n, p in state.model.named_parameters()}

    def largest(g, prefix):
        return max(float(np.abs(v).max()) for n, v in g.items() if n.startswith(prefix))

    for grad in (jgrad, tgrad):
        motion, skin = grad("loss_motion"), grad("loss_skin")
        aggr, head = largest(motion, "motion.aggregator."), largest(motion, HEADS[0])
        assert aggr <= 1e-8 * largest(skin, "skinNet."), (grad.__name__, aggr)
        assert head >= 1e5 * aggr, (grad.__name__, head, aggr)


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
