"""The port's skeleton training slice against the JAX package, on the CPU:
the capsule and creature skeleton datasets, BoneNet's and RootNet's
training forwards, one BoneStage and one RootStage step, BoneNet's dropout
and pair swap, the host volumetric geodesic, and `capsule_predictor`.

Sizes: capsules at num_points=64, n_lat=9, n_lon=8 (V=74 padded to 256,
degree-16 tables), max_joints=8 (P=28 pairs), B=2; creatures at
target_verts=300.  The JAX side trains through its Pallas edge kernels in
interpret mode (`jax_training_kernels`) with exact top-k radius grouping;
BoneNet runs with dropout 0 on both sides and the port is fed the pair
swap JAX drew.  Each step is held module by module: every module of the
network fed the input and the output gradient it had in JAX's step (read
by intercepting its call), its parameters' gradients at LAYER_GRAD for the
edge-layer GCUs and at TIGHT_GRAD for the fp32 modules
(torch_port_fixtures states both).  Measured on one CPU: the GCUs' outputs
within 1.8e-6 (mean) and 3.0e-4 (max) relative, their gradients within
1.1e-4 and 3.1e-4; the fp32 modules' outputs and gradients within 1.8e-6;
the logits within 2.0e-4 (mean, NETWORK's bound is 2e-2).
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morig_tpu.core.batch import MeshBatch as JMeshBatch
from morig_tpu.data import creature as jcreature
from morig_tpu.data import skeleton_data as jskel
from morig_tpu.geometry import geodesic as jgeo
from morig_tpu.geometry import voxel as jvox
from morig_tpu.kernels import neighbors as jnb
from morig_tpu.losses.basic import bce_with_logits
from morig_tpu.nn import bonenet as jbn
from morig_tpu.train import stages as jstages
from morig_tpu_torch import weights as W
from morig_tpu_torch.core.batch import MeshBatch
from morig_tpu_torch.data import creature as tcreature
from morig_tpu_torch.data import skeleton_data as tskel
from morig_tpu_torch.geometry import geodesic as tgeo
from morig_tpu_torch.geometry.bones import point_to_segment_dist
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry import voxel as tvox
from morig_tpu_torch.kernels import edge_fused as tef
from morig_tpu_torch.kernels import gather_fused as tgf
from morig_tpu_torch.nn import bonenet as tbn
from morig_tpu_torch.pipelines import rig_predict as trp
from morig_tpu_torch.train import stages as tstages

import torch_port_fixtures as F
from torch_port_fixtures import (LAYER, LAYER_GRAD, NETWORK, TIGHT, TIGHT_GRAD, assert_close,
                                 assert_rel_close)

SKEL_DATA = dict(num_points=64, n_lat=9, n_lon=8)
CREATURES = dict(num_models=2, seed=3, target_verts=300)
MESH_KEYS = ("verts", "vert_mask", "tpl_nbr", "tpl_mask", "geo_nbr", "geo_mask")


def _assert_skel_equal(jb, tb):
    """Every array of two SkelSamples equal; the index arrays (int32 in JAX,
    int64 here) by value."""
    for k in MESH_KEYS:
        np.testing.assert_array_equal(getattr(tb.mesh, k).numpy(), np.asarray(getattr(jb.mesh, k)),
                                      err_msg=k)
    for f in dataclasses.fields(tb):
        if f.name != "mesh":
            got = getattr(tb, f.name)
            assert got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jb, f.name)),
                                          err_msg=f.name)


# ---------------------------------------------------------------------------
# (a) the skeleton datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["capsule", "creature"])
def test_skel_datasets_match_jax(kind):
    """capsule_skel_dataset and creature_skel_dataset (the GT joint set and
    two copies jittered from default_rng(seed + 4242) per creature, the
    2048-bucket tables) give JAX's arrays: joints, masks, pairs, the
    [distance, inside fraction] attributes, adjacency labels and roots."""
    if kind == "capsule":
        jb = jskel.capsule_skel_dataset(num_models=2, max_joints=8, **SKEL_DATA)
        tb = tskel.capsule_skel_dataset(num_models=2, max_joints=8, device="cpu", **SKEL_DATA)
        assert tb.pairs.shape == (2, 28, 2) and tb.mesh.verts.shape == (2, 256, 3)
    else:
        jb = jcreature.creature_skel_dataset(**CREATURES)
        tb = tcreature.creature_skel_dataset(device="cpu", **CREATURES)
        assert tb.joints.shape == (6, 32, 3) and tb.pairs.shape == (6, 496, 2)
        assert not torch.equal(tb.joints[0], tb.joints[1])
    _assert_skel_equal(jb, tb)
    assert float(tb.pair_label.sum()) > 0


# ---------------------------------------------------------------------------
# (b), (c): the training forwards and one step of each stage
# ---------------------------------------------------------------------------

# (JAX module path, kind): every module whose parameters the step trains.
# "gcu": two edge layers through K1 + K6, held at LAYER / LAYER_GRAD; the
# others are fp32 on both sides and held at TIGHT / TIGHT_GRAD.
SHAPE_MODULES = [(("shape_encoder", f"gcu_{i}"), "gcu") for i in (1, 2, 3)] + [
    (("shape_encoder", "mlp_glb"), "mlp")]
MODULES = {
    "bone": SHAPE_MODULES + [(("joint_encoder", "sa1"), "sa"), (("joint_encoder", "sa2"), "sa"),
                             (("joint_encoder", "sa3"), "gsa"),
                             (("expand_joint_feature",), "mlp"), (("mix_transform",), "mlp"),
                             (("out",), "dense")],
    "root": SHAPE_MODULES + [(("sa1",), "sa"), (("sa2",), "sa"), (("sa3",), "gsa"),
                             (("fp3",), "fp"), (("fp2",), "fp"), (("fp1",), "fp"),
                             (("back_layers",), "mlp")],
}
PAIR_KEY = 21
# A gradient below ZERO_GRAD x its module's largest is held as zero on both
# sides (rounding noise of a sum that cancels exactly).
ZERO_GRAD = 1e-5


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _jax_step(kind, jb, params, model, jstage):
    """JAX's loss, logits, parameter gradients and, for each module of
    MODULES[kind], its call's inputs, its output and the gradient of the
    loss with respect to that output (an added zero the interceptor puts on
    the module's output; a tuple output's first element)."""
    paths = {p for p, _ in MODULES[kind]}
    k_perm, k_drop = jax.random.split(jax.random.key(PAIR_KEY))

    def apply(p, eps, record):
        def interceptor(next_fun, args, kwargs, ctx):
            out = next_fun(*args, **kwargs)
            path = tuple(ctx.module.path)
            if ctx.method_name != "__call__" or path not in paths:
                return out
            # python flags (train) do not leave the jitted function
            record[path] = (tuple(None if isinstance(a, bool) else a for a in args), _first(out))
            if eps is None:
                return out
            if isinstance(out, tuple):
                return (out[0] + eps[path],) + tuple(out[1:])
            return out + eps[path]

        with nn.intercept_methods(interceptor):
            if kind == "bone":
                logits = model.apply({"params": p}, jb.mesh, jb.joints, jb.joints_mask, jb.pairs,
                                     jb.pair_attr, True, True, k_perm, rngs={"dropout": k_drop})
                loss = bce_with_logits(logits[..., 0], jb.pair_label, jb.pair_mask)
                return loss, (dict(total_loss=loss), logits)
            logits = model.apply({"params": p}, jb.mesh, jb.joints, jb.joints_mask, True)
            loss, metrics = jstage._loss(logits, jb)
            return loss, (metrics, logits)

    def shapes(p):
        record = {}
        apply(p, None, record)
        return {k: v[1] for k, v in record.items()}

    eps = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(shapes, params))

    def loss_fn(p, e):
        record = {}
        loss, aux = apply(p, e, record)
        return loss, aux + (record,)

    (_, (metrics, logits, record)), (jgrads, jdouts) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(params, eps)
    swap = np.asarray(jax.random.bernoulli(k_perm, 0.5, jb.pairs.shape[:2] + (1,)))
    return dict(metrics=metrics, logits=logits, grads=jgrads, douts=jdouts, record=record,
                swap=swap)


def _torch(x):
    if x is None:
        return x
    if isinstance(x, JMeshBatch):
        return MeshBatch(*(_torch(getattr(x, k)).long() if "nbr" in k else _torch(getattr(x, k))
                           for k in MESH_KEYS))
    return torch.as_tensor(np.array(x))


def _port_module(net, path, kind, args):
    """The port's module at `path` on JAX's call arguments, in training:
    its output (a tuple's first element)."""
    mod = net
    for name in path:
        mod = getattr(mod, name)
    a = [_torch(x) for x in args]
    if kind == "gcu":                      # (x, mesh, train)
        return mod(a[0], a[1], train=True)
    if kind == "sa":                       # (x, pos, mask, train) + num_out from the path
        n_in = a[1].shape[1]
        num_out = n_in if path[-1] == "sa1" else max(n_in // 3, 1)
        return mod(a[0], a[1], a[2], num_out, train=True)[0]
    if kind == "gsa":                      # (x, pos, mask, train)
        return mod(a[0], a[1], a[2], train=True)
    if kind == "fp":                       # (x, pos, mask, x_skip, pos_skip, mask_skip, train)
        return mod(*a[:6], train=True)[0]
    if kind == "mlp":                      # (x, mask, train)
        return mod(a[0], train=True)
    return mod(a[0])                       # dense: (x,)


@pytest.fixture(scope="module", params=["bone", "root"])
def skel_step(request):
    """One step of BoneStage or RootStage on both sides from the same
    seeded weights (every parameter, the zero-initialized heads included,
    filled by random_params) and the capsule skeleton sample."""
    kind = request.param
    jb = jskel.capsule_skel_dataset(num_models=2, max_joints=8, **SKEL_DATA)
    tb = tskel.capsule_skel_dataset(num_models=2, max_joints=8, device="cpu", **SKEL_DATA)
    if kind == "bone":
        jstage, stage = jstages.BoneStage(), tstages.BoneStage()
        model = jstage.model = jbn.BoneNet(dropout=0.0)
        init_args = (jb.mesh, jb.joints, jb.joints_mask, jb.pairs, jb.pair_attr)
    else:
        jstage, stage = jstages.RootStage(), tstages.RootStage()
        model = jstage.model
        init_args = (jb.mesh, jb.joints, jb.joints_mask)
    jnb.set_topk_mode("exact")
    try:
        with F.jax_training_kernels():
            params = F.flax_params(model, 83 if kind == "bone" else 84, *init_args)
            ref = _jax_step(kind, jb, params, model, jstage)
    finally:
        jnb.set_topk_mode("auto")
    tx = jstage.make_tx()
    updates, _ = tx.update(ref["grads"], tx.init(params), params)
    jnew = W.flax_to_state_dict(optax.apply_updates(params, updates))

    state = stage.init_state(device="cpu")
    state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
    if kind == "bone":
        state.model.dropout = 0.0
    swap = torch.as_tensor(np.array(ref["swap"]))
    # the forward and the step draw the swap from their generator: JAX's instead
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbn, "pair_swap", lambda generator, B, P, device: swap)
        if kind == "bone":
            logits = state.model(tb.mesh, tb.joints, tb.joints_mask, tb.pairs, tb.pair_attr,
                                 train=True, permute=True)
        else:
            logits = state.model(tb.mesh, tb.joints, tb.joints_mask, train=True)
        before = (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches,
                  tgf.gather_rows.launches)
        metrics = stage.train_step(state, tb, torch.Generator().manual_seed(0))
        assert before == (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches,
                          tgf.gather_rows.launches)
    return dict(kind=kind, ref=ref, params=params, jnew=jnew, logits=logits.detach(),
                metrics=metrics, state=state, stage=stage, batch=tb)


def test_skel_train_forward_matches_flax(skel_step):
    """BoneNet (permute, JAX's swap, dropout 0) and RootNet in training:
    the logits at NETWORK (6 edge layers in the shape code)."""
    ref = np.asarray(skel_step["ref"]["logits"])
    mask = np.asarray(skel_step["batch"].pair_mask if skel_step["kind"] == "bone"
                      else skel_step["batch"].joints_mask)
    assert_rel_close(skel_step["logits"], ref, NETWORK, mask, "logits")
    if skel_step["kind"] == "bone":
        assert 0 < skel_step["ref"]["swap"].sum() < skel_step["ref"]["swap"].size


def test_skel_step_modules_match_jax(skel_step):
    """Each module fed the inputs and output gradient of JAX's step: output
    and every parameter gradient at LAYER / LAYER_GRAD (GCUs) or TIGHT /
    TIGHT_GRAD (fp32 modules); together the modules cover every parameter,
    and with the heads filled only the two RootNet biases whose gradient the
    loss cancels are zero."""
    ref = skel_step["ref"]
    net = F.bridged(tbn.BoneNet if skel_step["kind"] == "bone" else tbn.RootNet,
                    W.flax_to_state_dict(skel_step["params"])).train()
    jgrads = W.flax_to_state_dict(ref["grads"])
    covered, zero = set(), []
    for path, kind in MODULES[skel_step["kind"]]:
        args, jout = ref["record"][path]
        mod = net
        for name in path:
            mod = getattr(mod, name)
        mod.zero_grad(set_to_none=True)
        out = _port_module(net, path, kind, args)
        out.backward(torch.as_tensor(np.asarray(ref["douts"][path])))
        out_tol, grad_tol = (LAYER, LAYER_GRAD) if kind == "gcu" else ((TIGHT, TIGHT), TIGHT_GRAD)
        what = ".".join(path)
        if kind == "gcu":
            assert_rel_close(out, jout, out_tol, np.asarray(args[1].vert_mask), what)
        else:
            assert_close(out, jout, atol=TIGHT, rtol=TIGHT, what=what)
        prefix = what + "."
        scale = max(float(np.abs(np.asarray(jgrads[prefix + n])).max())
                    for n, _ in mod.named_parameters())
        assert scale > 0, what
        for n, p in mod.named_parameters():
            covered.add(prefix + n)
            g_ref = np.asarray(jgrads[prefix + n])
            if np.abs(g_ref).max() <= ZERO_GRAD * scale:
                # zero but for rounding: RootNet's softmax cross-entropy
                # gradient sums to 0 over the joints, and so does that of
                # every bias after the per-joint head's last LayerNorm
                assert p.grad.abs().max() <= ZERO_GRAD * scale, prefix + n
                zero.append(prefix + n)
            else:
                assert_rel_close(p.grad, g_ref, grad_tol, what=prefix + n)
    assert covered == set(jgrads) == {n for n, _ in net.named_parameters()}
    assert zero == ([] if skel_step["kind"] == "bone" else
                    ["back_layers.mlp.ln_1.bias", "back_layers.out.bias"]), zero


# Adam's first step moves each parameter by lr * g / (|g| + eps): about lr
# times the sign of its effective gradient g (clipped, plus the L2 decay),
# whatever |g|.  So the step is held where JAX's |g| is at least UPDATE_HELD
# times the largest of its tensor and at least UPDATE_FLOOR (far above
# Adam's eps, and above the decay's share where the loss's gradient is zero
# by its form): there the port's step has the sign of JAX's and lies within
# 1e-2 lr of it (up to the rounding of p +- lr), on at least UPDATE_AGREE of
# the held entries in all and UPDATE_AGREE_TENSOR in each tensor.  A zero or
# sign-flipped update fails.  Some entries
# may miss: the shape code is a max over vertices, so a gradient routed by
# a near-tie of the max differs between the sides.  Measured on one CPU:
# 0.9964 of 502,337 held entries agree in the Bone step (half its
# parameters held), 0.9998 of 498,478 in the Root step (0.48 held); the
# worst tensor, gcu_1's geo edge-layer bias, 27 of 30.
UPDATE_HELD, UPDATE_FLOOR = 1e-2, 1e-4
UPDATE_AGREE, UPDATE_AGREE_TENSOR = 0.99, 0.75


def adam_first_step_agreement(before, after, ref_after, ref_g, lr, what):
    """The per-tensor part of the check above; returns (entries held,
    entries whose step agrees with JAX's)."""
    before, after, ref_after, ref_g = (F.np_(x).astype(np.float64).ravel()
                                       for x in (before, after, ref_after, ref_g))
    held = np.abs(ref_g) >= max(UPDATE_HELD * np.abs(ref_g).max(), UPDATE_FLOOR)
    if not held.any():
        return 0, 0
    d, d_ref = (after - before)[held], (ref_after - before)[held]
    assert np.abs(d_ref).min() >= 0.5 * lr, what
    agree = (np.sign(d) == np.sign(d_ref)) & (
        np.abs(d - d_ref) <= 1e-2 * lr + 1e-6 * np.abs(before[held]))
    assert agree.mean() >= UPDATE_AGREE_TENSOR, (what, int(held.sum()), int(agree.sum()))
    return int(held.sum()), int(agree.sum())


def test_skel_step_losses_and_update_match_jax(skel_step):
    """The step's losses at NETWORK relative (root_acc exactly), its
    gradient norm (before the clip) at NETWORK relative to optax's global
    norm of JAX's gradients, and the parameters after it: all within 2 lr
    (1e-3) of JAX's, and where JAX's gradient is not near zero (at least
    0.4 of the parameters), moved as JAX's step moved them
    (adam_first_step_agreement)."""
    jm, m = skel_step["ref"]["metrics"], skel_step["metrics"]
    assert set(jm) | {"grad_norm"} == set(m)
    for k, r in jm.items():
        if k == "root_acc":
            assert m[k] == float(r)
        else:
            assert abs(m[k] - float(r)) <= NETWORK[0] * abs(float(r)), (k, m[k], float(r))
    jnorm = float(optax.global_norm(skel_step["ref"]["grads"]))
    assert abs(m["grad_norm"] - jnorm) <= NETWORK[0] * jnorm, (m["grad_norm"], jnorm)
    params = W.flax_to_state_dict(skel_step["params"])
    jgrads = W.flax_to_state_dict(skel_step["ref"]["grads"])
    clip, wd = min(1.0, 10.0 / jnorm), skel_step["stage"].cfg.train.weight_decay
    held = agree = total = 0
    for n, p in skel_step["state"].model.named_parameters():
        assert_close(p.detach(), skel_step["jnew"][n], atol=2 * 1e-3, rtol=1e-6, what=n)
        g = clip * F.np_(jgrads[n]) + wd * F.np_(params[n])
        h, a = adam_first_step_agreement(params[n], p, skel_step["jnew"][n], g, 1e-3, n)
        held, agree, total = held + h, agree + a, total + p.numel()
    assert held >= 0.4 * total and agree >= UPDATE_AGREE * held, (held, agree, total)


def test_skel_steps_lower_the_loss(skel_step):
    """Four more steps with the port's own draws (BoneNet at its 0.7
    dropout) lower the eval loss; eval_step is deterministic and infer
    gives the inference logits without a graph."""
    stage, state, batch = skel_step["stage"], skel_step["state"], skel_step["batch"]
    if skel_step["kind"] == "bone":
        state.model.dropout = 0.7
    first = stage.eval_step(state, batch)
    assert first == stage.eval_step(state, batch)
    g = torch.Generator().manual_seed(1)
    for _ in range(4):
        m = stage.train_step(state, batch, g)
        assert all(np.isfinite(v) for v in m.values()), m
    assert stage.eval_step(state, batch)["total_loss"] < first["total_loss"]
    out = stage.infer(state, batch)
    width = 28 if skel_step["kind"] == "bone" else 8
    assert out.shape == (2, width, 1) and not out.requires_grad


# ---------------------------------------------------------------------------
# (d) BoneNet's dropout and pair swap
# ---------------------------------------------------------------------------

def test_dropout_and_pair_swap_draws():
    """Dropout at rate 0.7 keeps a share of 0.3 (within 5 binomial standard
    deviations over 64,000 entries), scales the kept entries by 1/0.3 and
    zeroes the rest; one generator seed gives one mask; the pair swap marks
    half the pairs (5 sd) and repeats with the seed."""
    x = torch.randn(4, 250, 64, generator=torch.Generator().manual_seed(0)) + 3.0
    y = tbn.dropout(x, 0.7, torch.Generator().manual_seed(5))
    kept = y != 0
    n = x.numel()
    assert abs(kept.sum().item() - 0.3 * n) <= 5 * np.sqrt(n * 0.3 * 0.7)
    torch.testing.assert_close(y[kept], x[kept] / 0.3, rtol=0, atol=0)
    assert torch.equal(tbn.dropout(x, 0.7, torch.Generator().manual_seed(5)), y)
    assert not torch.equal(tbn.dropout(x, 0.7, torch.Generator().manual_seed(6)), y)
    assert tbn.dropout(x, 0.0, None) is x
    s = tbn.pair_swap(torch.Generator().manual_seed(2), 8, 1000, "cpu")
    assert s.shape == (8, 1000, 1) and s.dtype == torch.bool
    assert abs(s.sum().item() - 4000) <= 5 * np.sqrt(8000 * 0.25)
    assert torch.equal(s, tbn.pair_swap(torch.Generator().manual_seed(2), 8, 1000, "cpu"))


def test_bonenet_dropout_only_in_training():
    """At inference BoneNet applies neither the dropout nor a swap (its
    logits do not depend on the rate or the generator); in training the
    dropout changes them and one generator seed repeats them."""
    tb = tskel.capsule_skel_dataset(num_models=2, max_joints=8, device="cpu", **SKEL_DATA)
    net = W.randomize_(tbn.BoneNet(), 4)
    args = (tb.mesh, tb.joints, tb.joints_mask, tb.pairs, tb.pair_attr)
    with torch.no_grad():
        ref = net(*args)
        again = net(*args, permute=True, generator=torch.Generator().manual_seed(1))
        net.dropout = 0.0
        plain = net(*args, train=True)
        net.dropout = 0.7
        dropped = [net(*args, train=True, generator=torch.Generator().manual_seed(3))
                   for _ in range(2)]
    assert torch.equal(ref, again)
    assert torch.equal(dropped[0], dropped[1]) and not torch.equal(dropped[0], plain)


# ---------------------------------------------------------------------------
# (e) the host volumetric geodesic
# ---------------------------------------------------------------------------

def test_vertex_bone_geodesic_matches_jax():
    """The host vertex_bone_geodesic on a creature (256 vertices, 21 bones,
    its 88^3 grid) fed the same surface geodesics: within 1e-6 + 1e-5
    relative of JAX's (measured 1.3e-8 absolute, 5.7e-7 relative: fp32
    point-to-segment distances summed in another order), and the pruned
    visibility leaves both visible and occluded pairs."""
    c = tcreature.make_creature(3, target_verts=300)
    rig = sk.Rig(names=list(c.names), pos=c.joints.astype(np.float64), parents=c.parents,
                 skins=c.skins)
    bones, _, _ = sk.get_bones(rig)
    vox = tvox.voxelize_mesh(c.verts, c.faces)
    sg = jgeo.surface_geodesic(c.verts, c.faces)
    got = tgeo.vertex_bone_geodesic(c.verts, bones, vox, surface_geo=sg, device="cpu")
    ref = jgeo.vertex_bone_geodesic(c.verts, bones,
                                    jvox.Voxels(vox.data, vox.translate, vox.scale, vox.dims),
                                    surface_geo=sg)
    assert got.shape == (len(c.verts), len(bones)) and got.dtype == np.float64
    assert_close(got, ref, atol=1e-6, rtol=1e-5, what="geodesic")
    straight = point_to_segment_dist(torch.as_tensor(c.verts[None]),
                                          torch.as_tensor(bones[None], dtype=torch.float32))[0]
    longer = got > straight[0].numpy() + 1e-4
    assert 0 < longer.sum() < longer.size
    with pytest.raises(ValueError, match="faces"):
        tgeo.vertex_bone_geodesic(c.verts, bones, vox, device="cpu")


# ---------------------------------------------------------------------------
# (f) capsule_predictor
# ---------------------------------------------------------------------------

def test_capsule_predictor_untrained_is_the_stages_init():
    """train_steps=0: the predictor's six networks are the stages'
    init_state(seed) networks, parameter for parameter; the datasets are
    the two-capsule fixture."""
    pred, pose_ds, rig_ds = trp.capsule_predictor(train_steps=0, seed=2, device="cpu")
    stages = (tstages.DeformPoseStage(), tstages.RigStage(arch="jointnet"),
              tstages.RigStage(arch="masknet"), tstages.RootStage(), tstages.BoneStage(),
              tstages.SkinStage())
    for name, stage in zip(trp.NETS, stages):
        ref = stage.init_state(2, device="cpu").model.state_dict()
        got = getattr(pred, name).state_dict()
        assert set(got) == set(ref), name
        for k in ref:
            assert torch.equal(got[k], ref[k]), (name, k)
    assert len(pose_ds) == len(rig_ds) == 2 and rig_ds.pad_verts == 256
    assert not pred.training


def test_capsule_predictor_trains_and_rigs():
    """train_steps=2: the trained networks moved from their init, and
    predict_rig on each pose model (points of frames 1-5, as `predict-rig`
    serves them) gives finite joints and skin rows summing to 1."""
    pred, pose_ds, rig_ds = trp.capsule_predictor(train_steps=2, device="cpu")
    for name, stage in (("bone", tstages.BoneStage()), ("root", tstages.RootStage())):
        init = stage.init_state(0, device="cpu").model.state_dict()
        got = getattr(pred, name).state_dict()
        assert any(not torch.equal(got[k], init[k]) for k in init), name
    for i, m in enumerate(pose_ds.models):
        pts = np.stack([m.pts_traj[:, t, :] for t in range(1, 6)])
        rig = pred.predict_rig(rig_ds._mesh_cache[i], pts)
        n_valid = int(rig_ds._mesh_cache[i]["vert_mask"].sum())
        assert len(rig.pos) >= 1 and np.isfinite(rig.pos).all()
        assert rig.skins.shape == (n_valid, len(rig.pos))
        assert np.abs(rig.skins.sum(1) - 1.0).max() <= 1e-3
