"""Training in the "batch" norm mode against the JAX package, on the CPU.

One CorrPoseStage step (B=4 capsules, P=256) and one RigStage step
(jointnet at width_scale 0.25, T=2) from the same seeded parameters and
BatchNorm statistics on both sides; one DeformPoseStage step with the
extractor frozen; the port's checkpoints round-tripping the statistics.

Both sides are fp32 in this mode (no edge kernel: the JAX package refuses
its fused edge path outside "layer" mode, the port runs its BatchNorm edge
tails in plain PyTorch), but for the vismask head's kNN, bf16 on both (the
JAX side through its Pallas kernel in interpret mode, with its VJP).

The JAX step runs eagerly, not under jax.jit: on the CPU the jitted
gradient of a training-mode MaskedBatchNorm followed by a masked max over
the table (every batch-mode edge layer) differs from JAX's own eager
gradient and from PyTorch's autograd, which agree to 1e-6; a directional
finite difference in float64 sides with them (-13.512 against eager
-13.518 and jitted -14.940).  On the rig step the jitted gradient norm is
685, the eager one 1184.43, the port's 1205.08.

The step is held:
  * by its losses, within STEP_LOSS relative (measured: at most 2.4e-5,
    the vismask BCE);
  * module by module: each module whose parameters the step trains is run
    on the port with the inputs and the output gradient JAX's step gave it
    (a flax interceptor adds a zero to each output: its gradient is the
    module's dout), in training, every call of it in order (the shared
    motion trunk once per keyframe): its outputs within MODULE_OUT
    (measured: mean 2.7e-6, max 9.4e-6 relative), its parameter gradients
    summed over its calls within MODULE_GRAD of JAX's (measured: 1.3e-3
    mean, 1.5e-3 max for the first motion layer's `lin_self.bias`, a sum
    over all edges that the BatchNorm after it makes cancel; elsewhere at
    most 1.2e-4), and its running statistics after those calls within
    STATS of JAX's after the step (the motion trunk's after its T=2
    updates); the norm of those module gradients within STEP_LOSS of
    optax's global norm of JAX's gradients (measured 4e-7);
  * by the gradient norm of the port's own step, within GRAD_NORM of
    JAX's (measured: 1.3e-2 CorrNet, 1.7e-2 the rig step).  The whole
    step's gradient moves more than its losses: a max over vertices routes
    each channel's gradient to one vertex, which an fp32-level difference
    can move to another, and a channel of small batch variance multiplies
    its gradient by up to 1/sqrt(eps) ~ 316.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from morig_tpu.core.batch import MeshBatch as JMeshBatch
from morig_tpu.data import pose as jpose
from morig_tpu.nn import corrnet as jcn
from morig_tpu.train import stages as jstages
from morig_tpu_torch import weights as W
from morig_tpu_torch.core.batch import MeshBatch
from morig_tpu_torch.data import pose as tpose
from morig_tpu_torch.kernels import edge_fused as tef
from morig_tpu_torch.losses import nce as tnce
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.train import checkpoint as tckpt
from morig_tpu_torch.train import stages as tstages

import torch_port_fixtures as F
from test_torch_rig_train import JCFG, NUM_SAMPLE, T_KEY, TCFG, _rig_datasets
from torch_port_fixtures import assert_rel_close

DATA = dict(num_models=4, num_frames=4, num_points=256, n_lat=7, n_lon=6)
STEP_LOSS = 1e-4
GRAD_NORM = 5e-2
MODULE_OUT = (1e-5, 5e-5)
MODULE_GRAD = (5e-3, 5e-3)
STATS = 1e-4
MESH_KEYS = ("verts", "vert_mask", "tpl_nbr", "tpl_mask", "geo_nbr", "geo_mask")

# (module path, kind): every module whose parameters the step trains
CORR_MODULES = (
    [(("mesh_enc", f"vtx_gcu_{i}"), "gcu") for i in range(1, 5)]
    + [(("mesh_enc", "vtx_mlp_glb"), "mlp"), (("mesh_enc", "vtx_mlp"), "mlp")]
    + [(("pts_enc", f"sa{i}"), "sa") for i in (1, 2, 3)] + [(("pts_enc", "sa4"), "gsa")]
    + [(("pts_enc", f"fp{i}"), "fp") for i in (4, 3, 2, 1)]
    + [(("pts_enc", "pts_mlp"), "mlp"), (("lin_vismask",), "mlp")])
RIG_MODULES = (
    [(("motion", "motionNet", f"gcu_{i}"), "gcu_motion") for i in (1, 2, 3)]
    + [(("motion", "motionNet", n), "mlp") for n in ("mlp_glb", "mlp_transform")]
    + [(("motion", "aggregator"), "attn")]
    + [(("jointnet", f"gcu_{i}"), "gcu_motion") for i in (1, 2, 3)]
    + [(("jointnet", n), "mlp") for n in ("mlp_glb", "mlp_transform")])


@pytest.fixture(scope="module")
def batch_mode():
    with F.norm_mode("batch"):
        yield


def _pose_datasets():
    jds = jpose.capsule_pose_dataset(**DATA)
    tds = tpose.capsule_pose_dataset(**DATA)
    kw = dict(tpl_max_degree=12, geo_max_degree=12, buckets=(128,))
    return jpose.PoseDataset(jds.models, **kw), tpose.PoseDataset(tds.models, **kw)


def _edge_counts():
    return (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_windowed.launches,
            tef.fused_edge_mlp_bwd.launches, tgcu.plain_edge.launches)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def jax_step(loss_of, params, paths):
    """JAX's step (eager) through `loss_of(p) -> (loss, (metrics,
    batch_stats))` with every call of the modules at `paths` recorded: its arguments, its
    output and the gradient of the loss with respect to that output.
    Returns (metrics, updated batch_stats, grads, {path: [(args, out,
    dout), ...]})."""

    def run(p, eps, record):
        count: dict = {}

        def interceptor(next_fun, args, kwargs, ctx):
            out = next_fun(*args, **kwargs)
            path = tuple(ctx.module.path)
            if ctx.method_name != "__call__" or path not in paths:
                return out
            i = count[path] = count.get(path, -1) + 1
            record.setdefault(path, []).append(
                (tuple(None if isinstance(a, bool) else a for a in args), _first(out)))
            if eps is None:
                return out
            if isinstance(out, tuple):
                return (out[0] + eps[path][i],) + tuple(out[1:])
            return out + eps[path][i]

        with nn.intercept_methods(interceptor):
            return loss_of(p)

    def shapes(p):
        record: dict = {}
        run(p, None, record)
        return {k: [out for _, out in v] for k, v in record.items()}

    eps = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                 jax.eval_shape(shapes, params))

    def loss_fn(p, e):
        record: dict = {}
        loss, aux = run(p, e, record)
        return loss, aux + (record,)

    (_, (metrics, stats, record)), (grads, douts) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, eps)
    calls = {k: [(args, out, d) for (args, out), d in zip(v, douts[k])]
             for k, v in record.items()}
    return metrics, stats, grads, calls


def _torch(x):
    if x is None:
        return x
    if isinstance(x, JMeshBatch):
        return MeshBatch(*(_torch(getattr(x, k)).long() if "nbr" in k else _torch(getattr(x, k))
                           for k in MESH_KEYS))
    return torch.as_tensor(np.array(x))


def _call_port(mod, kind, args, out):
    """The port's module on JAX's call arguments, in training."""
    a = [_torch(x) for x in args]
    if kind == "gcu":                      # (x, mesh, train)
        return mod(a[0], a[1], train=True)
    if kind == "gcu_motion":               # (pos, x, mesh, train)
        return mod(a[0], a[1], a[2], train=True)
    if kind == "sa":                       # (x, pos, mask, train, start)
        return mod(a[0], a[1], a[2], out.shape[1], train=True, start=a[4].long())[0]
    if kind == "gsa":                      # (x, pos, mask, train)
        return mod(a[0], a[1], a[2], train=True)
    if kind == "fp":                       # (x, pos, mask, x_skip, pos_skip, mask_skip, train)
        return mod(*a[:6], train=True)[0]
    return mod(a[0], a[1], train=True)     # MLP / MLPHead / TemporalAttn: (x, mask, train)


def _subtree(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_modules(net, modules, calls, jgrads, jstats):
    """Each module of `net` (the port network, as loaded before the step)
    on JAX's recorded calls; returns the squared norm of its gradients."""
    sq = 0.0
    for path, kind in modules:
        mod = net.get_submodule(".".join(path))
        what = ".".join(path)
        assert calls[path], what
        for args, out, dout in calls[path]:
            y = _call_port(mod, kind, args, out)
            assert_rel_close(y, out, MODULE_OUT, what=f"{what} output")
            y.backward(_torch(dout))
        ref = W.flax_to_state_dict(_subtree(jgrads, path))
        grads = {n: p.grad for n, p in mod.named_parameters()}
        assert set(grads) == set(ref), what
        for n, g in grads.items():
            assert_rel_close(g, ref[n], MODULE_GRAD, what=f"{what} d{n}")
            sq += float((g.double() ** 2).sum())
        ref = W.flax_to_state_dict({}, _subtree(jstats, path))
        stats = {k: v for k, v in mod.state_dict().items() if "running" in k}
        assert set(stats) == set(ref) and ref, what
        for k, v in ref.items():
            F.assert_close(stats[k], v, atol=STATS * float(v.abs().max()), rtol=STATS,
                           what=f"{what} {k}")
    return sq


def check_step(d, modules):
    """The whole step's losses and the module-by-module checks on the port
    network as loaded before the step (`d["fresh"]`)."""
    for k, v in d["jmetrics"].items():
        assert abs(d["metrics"][k] - float(v)) <= STEP_LOSS * abs(float(v)), (k, d["metrics"][k], v)
    sq = check_modules(d["fresh"], modules, d["calls"], d["jgrads"], d["jstats"])
    if "temperature" in d["jgrads"]:           # a parameter outside the modules
        sq += float(d["jgrads"]["temperature"]) ** 2
    jnorm = float(optax.global_norm(d["jgrads"]))
    assert abs(np.sqrt(sq) - jnorm) <= STEP_LOSS * jnorm, (np.sqrt(sq), jnorm)
    assert abs(d["metrics"]["grad_norm"] - jnorm) <= GRAD_NORM * jnorm, (d["metrics"], jnorm)


@pytest.fixture(scope="module")
def corr_step(batch_mode):
    """One CorrPoseStage train step on both sides (vismask branch on, FPS
    from index 0), from seeded parameters and statistics."""
    jds, tds = _pose_datasets()
    jb, tb = jds.batch([0, 1, 2, 3], 0, 2), tds.batch([0, 1, 2, 3], 0, 2, device="cpu")
    jstage, model = jstages.CorrPoseStage(), jcn.CorrNet()
    with F.jax_training_kernels():
        params, stats = F.flax_variables(model, 31, jb.mesh, jb.points, True, True)

        def loss_of(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, jb.mesh, jb.points, True,
                                   True, None, mutable=["batch_stats"])
            total, metrics = jstage._losses(out, jb, True)
            return total, (metrics, upd["batch_stats"])

        jmetrics, jstats, jgrads, calls = jax_step(loss_of, params, {p for p, _ in CORR_MODULES})
    stage = tstages.CorrPoseStage()
    stage.train_vismask = True
    sd = W.flax_to_state_dict(params, stats)
    state, fresh = stage.init_state(device="cpu"), stage.init_state(device="cpu").model
    state.model.load_state_dict(sd, strict=True)
    fresh.load_state_dict(sd, strict=True)
    before = _edge_counts()
    metrics = stage.train_step(state, tb)
    assert _edge_counts() == before
    return dict(jmetrics=jmetrics, jstats=jstats, jgrads=jgrads, calls=calls, metrics=metrics,
                state=state, stage=stage, batch=tb, fresh=fresh)


def test_corr_pose_step_batch_mode_matches_jax(corr_step):
    """CorrNet: the losses, and each trained module (4 GCUs, the mesh
    encoder's MLP and head, PointNet++'s 8 stages and head, the vismask
    head) on JAX's inputs and output gradients."""
    check_step(corr_step, CORR_MODULES)


def test_batch_mode_checkpoint_round_trips_the_statistics(corr_step, tmp_path):
    """The port's checkpoint of a "batch"-mode state restores every running
    statistic bit for bit, and eval_step then normalizes with them."""
    stage, state = corr_step["stage"], corr_step["state"]
    path = tckpt.save_checkpoint(state, str(tmp_path))
    fresh, _ = tckpt.load_checkpoint(stage.init_state(seed=3, device="cpu"), path)
    bufs = dict(state.model.named_buffers())
    assert len(bufs) > 80
    for n, b in fresh.model.named_buffers():
        assert torch.equal(b, bufs[n]), n
    assert stage.eval_step(fresh, corr_step["batch"]) == stage.eval_step(state, corr_step["batch"])


@pytest.fixture(scope="module")
def rig_step(batch_mode):
    """One RigStage (jointnet, width_scale 0.25, T=2) train step on both
    sides: pred_flow set to gt_flow on both (the 50/50 draw then does not
    matter) and the embedding loss replaying JAX's draws."""
    jds, tds = _rig_datasets()
    jb, tb = jds.batch([0, 1]), tds.batch([0, 1], device="cpu")
    jb = dataclasses.replace(jb, pred_flow=jb.gt_flow)
    tb = dataclasses.replace(tb, pred_flow=tb.gt_flow)
    jstage = jstages.RigStage(JCFG, "jointnet", num_embed_sample=NUM_SAMPLE, width_scale=0.25)
    stage = tstages.RigStage(TCFG, "jointnet", num_embed_sample=NUM_SAMPLE, width_scale=0.25)
    key = jax.random.key(11)
    params, stats = F.flax_variables(jstage.model, 71, jb.gt_flow, jb.mesh, True)

    def loss_of(p):
        out, upd = jstage.model.apply({"params": p, "batch_stats": stats}, jb.gt_flow, jb.mesh,
                                      True, mutable=["batch_stats"])
        total, metrics = jstage._losses(key, out, jb)
        return total, (metrics, upd["batch_stats"])

    jmetrics, jstats, jgrads, calls = jax_step(loss_of, params, {p for p, _ in RIG_MODULES})
    draws = [tuple(torch.as_tensor(d) for d in F.jax_multi_pos_draws(
        k, jb.gt_skin, jb.mesh.vert_mask, NUM_SAMPLE)) for k in jax.random.split(key, T_KEY + 1)]
    replay = itertools.cycle(draws)

    def replayed(generator, feature, gt_skin, vert_mask, num_sample):
        return tnce.multi_pos_info_nce_drawn(feature, gt_skin, vert_mask, *next(replay))

    sd = W.flax_to_state_dict(params, stats)
    state, fresh = stage.init_state(device="cpu"), stage.init_state(device="cpu").model
    state.model.load_state_dict(sd, strict=True)
    fresh.load_state_dict(sd, strict=True)
    before = _edge_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstages, "multi_pos_info_nce", replayed)
        metrics = stage.train_step(state, tb, torch.Generator().manual_seed(0))
    assert _edge_counts() == before
    return dict(jmetrics=jmetrics, jstats=jstats, jgrads=jgrads, calls=calls, metrics=metrics,
                fresh=fresh)


def test_rig_step_batch_mode_matches_jax(rig_step):
    """RigStage: the losses, and each trained module on JAX's inputs and
    output gradients; the shared motion trunk's modules are called once per
    keyframe, so their gradients are the sums over the T=2 calls and their
    running statistics those after T updates."""
    assert all(len(rig_step["calls"][p]) == T_KEY for p, _ in RIG_MODULES if p[1] == "motionNet")
    check_step(rig_step, RIG_MODULES)


def test_frozen_extractor_batch_mode_keeps_its_statistics(batch_mode):
    """A DeformPoseStage step in "batch" mode with the extractor frozen and
    loaded from a CorrNet: the extractor's parameters and running
    statistics stay as loaded bit for bit (its forward still normalizes
    with batch statistics), GCNDeform's running statistics move, and the
    step is finite.  Trained with the extractor, the extractor's statistics
    move too.  No edge kernel runs."""
    _, tds = _pose_datasets()
    tb = tds.batch([0, 1], 0, 2, device="cpu")
    corr = tstages.CorrPoseStage().init_state(seed=4, device="cpu")
    W.randomize_(corr.model, 4)
    loaded = dict(corr.model.state_dict())
    stage = tstages.DeformPoseStage()
    state = stage.init_extractor_from(stage.init_state(device="cpu"), corr)
    ext, comp = state.model.corr_extractor, state.model.completing
    comp_stats = [b.clone() for b in comp.buffers()]
    before = _edge_counts()
    m = stage.train_step(state, tb, torch.Generator().manual_seed(1))
    assert _edge_counts() == before
    assert np.isfinite(m["total_loss"]) and np.isfinite(m["grad_norm"])
    after = ext.state_dict()
    assert set(after) == set(loaded) and any(k.endswith("running_var") for k in after)
    for k, v in loaded.items():
        assert torch.equal(after[k], v), k
    assert any(not torch.equal(a, b) for a, b in zip(comp_stats, comp.buffers()))
    stage = tstages.DeformPoseStage(train_extractor=True)
    state = stage.init_extractor_from(stage.init_state(device="cpu"), corr)
    stage.train_step(state, tb, torch.Generator().manual_seed(1))
    moved = state.model.corr_extractor.state_dict()
    assert any(not torch.equal(moved[k], v) for k, v in loaded.items() if "running" in k)
