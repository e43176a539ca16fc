"""The port's motion training modules and its DeformPoseStage against the JAX
package, on the CPU.

The edge layers of GCUMotion, the MLP tails of GCNDeform and GCNRig, the
temporal aggregation and the new losses are held module by module, each fed
the same input and dout; then one DeformPoseStage step, with the extractor
frozen and trained, is held whole.  On a CPU tensor each port kernel
wrapper runs its plain version; the JAX side runs its Pallas kernels in
interpret mode (`jax_training_kernels`).  Inputs come from numpy seeds and
go to both sides; tolerances are those of torch_port_fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.core.config import DEFAULT_CONFIG
from morig_tpu.data import pose as jpose
from morig_tpu.kernels import neighbors as jnb
from morig_tpu.losses import basic as jloss
from morig_tpu.losses import nce as jnce
from morig_tpu.nn import corrnet as jcn
from morig_tpu.nn import deformnet as jdn
from morig_tpu.nn import gcu as jgcu
from morig_tpu.nn import mlp as jmlp
from morig_tpu.nn import rignet as jrn
from morig_tpu.train import stages as jstages
from morig_tpu_torch import weights as W
from morig_tpu_torch.data import pose as tpose
from morig_tpu_torch.kernels import edge_fused as tef
from morig_tpu_torch.kernels import knn_fused as tkf
from morig_tpu_torch.kernels import neighbors as tnb
from morig_tpu_torch.losses import basic as tloss
from morig_tpu_torch.losses import nce as tnce
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.nn import mlp as tmlp
from morig_tpu_torch.nn import rignet as trn
from morig_tpu_torch.train import checkpoint as tckpt
from morig_tpu_torch.train import stages as tstages

import torch_port_fixtures as F
from torch_port_fixtures import (EXTRACTOR_GRAD_TOTAL, EXTRACTOR_GROUP_L2, LAYER, LAYER_GRAD,
                                 NETWORK, STEP_GRAD, STEP_GRAD_TOTAL, TIGHT, TIGHT_GRAD,
                                 assert_close, assert_rel_close)

DATA = dict(num_models=2, num_frames=4, num_points=128, n_lat=7, n_lon=6)


def _grads_close(got: dict, ref: dict, tol, what: str):
    """Every gradient of `ref`, named as the port's state dict, against the
    port's."""
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for n, g in got.items():
        assert g is not None, (what, n)
        assert_rel_close(g, ref[n], tol, what=f"{what}.{n}")


# ---------------------------------------------------------------------------
# the motion modules' backward, each fed the same input and dout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_in,x_in,out,pos_feat", [
    (3, 3, 64, 16),       # GCNRig's gcu_1: x 32 wide, pos 16
    (3, 4, 128, 16),      # GCNDeform's gcu_1: x 64 wide (new to training), pos 16
    (33, 32, 256, 64),    # SkinNet's gcu1: x 128 wide, pos 64 over the bone descriptor
])
def test_gcu_motion_train_backward_matches_flax(pos_in, x_in, out, pos_feat):
    """A GCUMotion in training (its four edge layers through K1 forward and
    K6 backward, the fuse MLP in fp32), fed the same position channel,
    feature and dout on the valid vertices: the output at LAYER, both inputs'
    gradients and every parameter's gradient at LAYER_GRAD."""
    entries, _ = F.capsule_inputs(2)
    jm, tm = F.meshes(entries)
    vm = np.asarray(jm.vert_mask)
    rng = np.random.default_rng(out + pos_in)
    pos = rng.standard_normal((2, F.V_PAD, pos_in)).astype(np.float32)
    x = rng.standard_normal((2, F.V_PAD, x_in)).astype(np.float32)
    dout = rng.standard_normal((2, F.V_PAD, out)).astype(np.float32) * vm[..., None]
    m = jgcu.GCUMotion(out, dim_pos_feat=pos_feat)
    p = F.flax_params(m, out, jnp.asarray(pos), jnp.asarray(x), jm)

    def fwd_bwd(p_, pos_, x_, d_):
        y, vjp = jax.vjp(lambda pp, a, b: m.apply({"params": pp}, a, b, jm, True), p_, pos_, x_)
        return (y, *vjp(d_))

    with F.jax_training_kernels():
        ref, jdp, jdpos, jdx = jax.jit(fwd_bwd)(p, jnp.asarray(pos), jnp.asarray(x),
                                                jnp.asarray(dout))
    net = F.bridged(lambda: tgcu.GCUMotion(pos_in, x_in, out, pos_feat), W.flax_to_state_dict(p))
    assert all(mod.kernel_route for mod in net.modules() if isinstance(mod, tgcu.EdgeMLP))
    tpos, tx = (torch.as_tensor(a).requires_grad_() for a in (pos, x))
    before = tgcu.plain_edge.launches
    y = net(tpos, tx, tm, train=True)
    y.backward(torch.as_tensor(dout))
    assert tgcu.plain_edge.launches == before
    what = f"GCUMotion({pos_in},{x_in},{out})"
    assert_rel_close(y, ref, LAYER, vm, what)
    assert_rel_close(tpos.grad, jdpos, LAYER_GRAD, vm, f"{what} dpos")
    assert_rel_close(tx.grad, jdx, LAYER_GRAD, vm, f"{what} dx")
    _grads_close({n: q.grad for n, q in net.named_parameters()}, W.flax_to_state_dict(jdp),
                 LAYER_GRAD, what)


@pytest.mark.parametrize("net", ["deform", "rig"])
def test_gcn_tail_train_backward_matches_flax(net):
    """GCNDeform's and GCNRig's layers after their GCUs (mlp_glb, the masked
    global max, the concat with the positions and the input feature,
    mlp_transform) in training, fed the same skips, feature and dout: fp32 on
    both sides, so the inputs' and every parameter's gradients agree to
    TIGHT_GRAD."""
    skips_w, feat_w = {"deform": (896, 4), "rig": (832, 64)}[net]
    entries, _ = F.capsule_inputs(2)
    jm, tm = F.meshes(entries)
    vm = np.asarray(jm.vert_mask)
    rng = np.random.default_rng(skips_w)
    skips = rng.standard_normal((2, F.V_PAD, skips_w)).astype(np.float32)
    feat = rng.standard_normal((2, F.V_PAD, feat_w)).astype(np.float32)
    dout = rng.standard_normal((2, F.V_PAD, 3)).astype(np.float32) * vm[..., None]
    verts = np.asarray(jm.verts)
    jglb, jhead = jmlp.MLP([1024]), jmlp.MLPHead([1024, 256], 3, zero_init=True)
    pg = F.flax_params(jglb, 1, jnp.asarray(skips))
    ph = F.flax_params(jhead, 2, jnp.zeros((2, F.V_PAD, 1024 + 3 + feat_w + skips_w)))

    def jtail(pg_, ph_, s_, f_):
        x4 = jglb.apply({"params": pg_}, s_, jm.vert_mask, True)
        glb = jnp.broadcast_to(jnb.masked_max(x4, jm.vert_mask, axis=1)[:, None], x4.shape)
        return jhead.apply({"params": ph_}, jnp.concatenate([glb, verts, f_, s_], -1),
                           jm.vert_mask, True)

    ref, vjp = jax.vjp(jtail, pg, ph, jnp.asarray(skips), jnp.asarray(feat))
    jdg, jdh, jds, jdf = vjp(jnp.asarray(dout))
    glb_net = F.bridged(lambda: tmlp.MLP(skips_w, [1024]), W.flax_to_state_dict(pg))
    head = F.bridged(lambda: tmlp.MLPHead(1024 + 3 + feat_w + skips_w, [1024, 256], 3),
                     W.flax_to_state_dict(ph))
    ts, tf = (torch.as_tensor(a).requires_grad_() for a in (skips, feat))
    x4 = glb_net(ts, train=True)
    glb = tnb.masked_max(x4, tm.vert_mask, dim=1)[:, None].expand(-1, F.V_PAD, -1)
    y = head(torch.cat([glb, tm.verts, tf, ts], -1), train=True)
    y.backward(torch.as_tensor(dout))
    assert_rel_close(y, ref, TIGHT_GRAD, vm, f"{net} tail")
    assert_rel_close(ts.grad, jds, TIGHT_GRAD, vm, f"{net} skips")
    assert_rel_close(tf.grad, jdf, TIGHT_GRAD, vm, f"{net} feature")
    for mod, jd, what in ((glb_net, jdg, "mlp_glb"), (head, jdh, "mlp_transform")):
        _grads_close({n: q.grad for n, q in mod.named_parameters()}, W.flax_to_state_dict(jd),
                     TIGHT_GRAD, what)


@pytest.mark.parametrize("method", ["attn", "mean", "max"])
def test_temporal_aggregation_backward_matches_flax(method):
    """MotionAggregator's aggregation of per-keyframe features in training
    (TemporalAttn with its CLS token for `attn`, the mean or the max over the
    keyframes), then the L2 norm, fed the same features and dout: the output,
    the features' and the attention's parameter gradients at TIGHT_GRAD."""
    B, V, T, M = 2, 64, 3, 32
    rng = np.random.default_rng(len(method))
    feats = rng.standard_normal((B, V, T, M)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    width = 64 if method == "attn" else M
    dout = rng.standard_normal((B, V, width)).astype(np.float32)
    vm = jnp.ones((B, V), bool)
    agg = trn.MotionAggregator(T, M, method)
    if method == "attn":
        jattn = jrn.TemporalAttn()
        p = F.flax_params(jattn, 4, jnp.asarray(feats), vm)
        agg.aggregator.load_state_dict(W.flax_to_state_dict(p), strict=True)
        jfn = lambda p_, x: jcn.l2_normalize(jattn.apply({"params": p_}, x, vm, True))
    else:
        p = {}
        red = jnp.mean if method == "mean" else jnp.max
        jfn = lambda p_, x: jcn.l2_normalize(red(x, axis=2))
    ref, vjp = jax.vjp(jfn, p, jnp.asarray(feats))
    jdp, jdx = vjp(jnp.asarray(dout))
    tx = torch.as_tensor(feats).requires_grad_()
    y = agg.aggregate(tx, train=True)
    y.backward(torch.as_tensor(dout))
    assert_rel_close(y, ref, TIGHT_GRAD, what=f"{method} aggregate")
    assert_rel_close(tx.grad, jdx, TIGHT_GRAD, what=f"{method} dx")
    if method == "attn":
        _grads_close({n: q.grad for n, q in agg.aggregator.named_parameters()},
                     W.flax_to_state_dict(jdp), TIGHT_GRAD, "TemporalAttn")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_chamfer_and_skin_losses_match_jax():
    """chamfer_with_average, batched_chamfer_with_average and
    chamfer_directional (with and without masks, a sample with few valid
    joints), masked_l1_weighted and cross_entropy_with_probs (with and
    without a weight), values and gradients, fp32 on both sides: TIGHT."""
    rng = np.random.default_rng(21)
    B, V, J, K = 2, 50, 12, 5
    p1 = rng.standard_normal((B, V, 3)).astype(np.float32)
    p2 = rng.standard_normal((B, J, 3)).astype(np.float32)
    m1, m2 = rng.random((B, V)) < 0.8, rng.random((B, J)) < 0.7
    m2[1, 2:] = False
    for masks in ((m1, m2), (None, None)):
        jm = [None if m is None else jnp.asarray(m) for m in masks]
        tm = [None if m is None else torch.as_tensor(m) for m in masks]
        ref_dir = jax.vmap(jloss.chamfer_directional)(jnp.asarray(p1), jnp.asarray(p2), *jm) \
            if masks[0] is not None else jax.vmap(
                lambda a, b: jloss.chamfer_directional(a, b))(jnp.asarray(p1), jnp.asarray(p2))
        t1 = torch.as_tensor(p1).requires_grad_()
        got_dir = tloss.chamfer_directional(t1, torch.as_tensor(p2), *tm)
        for g, r, what in zip(got_dir, ref_dir, ("precision", "coverage")):
            assert_close(g, r, atol=TIGHT, rtol=TIGHT, what=what)
        ref_avg = (jax.vmap(jloss.chamfer_with_average)(jnp.asarray(p1), jnp.asarray(p2), *jm)
                   if masks[0] is not None else jax.vmap(
                       lambda a, b: jloss.chamfer_with_average(a, b))(jnp.asarray(p1),
                                                                     jnp.asarray(p2)))
        assert_close(tloss.chamfer_with_average(torch.as_tensor(p1), torch.as_tensor(p2), *tm),
                     ref_avg, atol=TIGHT, rtol=TIGHT, what="chamfer_with_average")
    jg = jax.grad(lambda a: jloss.batched_chamfer_with_average(
        a, jnp.asarray(p2), jnp.asarray(m1), jnp.asarray(m2)))(jnp.asarray(p1))
    t1 = torch.as_tensor(p1).requires_grad_()
    got = tloss.batched_chamfer_with_average(t1, torch.as_tensor(p2), torch.as_tensor(m1),
                                             torch.as_tensor(m2))
    assert_close(got, jloss.batched_chamfer_with_average(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m1), jnp.asarray(m2)),
        atol=TIGHT, rtol=TIGHT, what="batched chamfer")
    got.backward()
    assert_close(t1.grad, jg, atol=TIGHT, what="chamfer grad")

    pred, tgt = rng.standard_normal((2, B, V, 3)).astype(np.float32)
    wts = rng.uniform(0.5, 3.0, (B, V)).astype(np.float32)
    assert_close(tloss.masked_l1_weighted(*map(torch.as_tensor, (pred, tgt, m1, wts))),
                 jloss.masked_l1_weighted(*map(jnp.asarray, (pred, tgt, m1, wts))),
                 atol=TIGHT, rtol=TIGHT, what="masked_l1_weighted")
    logits = 3 * rng.standard_normal((B, V, K)).astype(np.float32)
    probs = rng.dirichlet(np.ones(K), (B, V)).astype(np.float32)
    w = (rng.random((B, V, K)) < 0.8).astype(np.float32)
    for weight in (None, w):
        jw = None if weight is None else jnp.asarray(weight)
        tw = None if weight is None else torch.as_tensor(weight)
        tl = torch.as_tensor(logits).requires_grad_()
        got = tloss.cross_entropy_with_probs(tl, torch.as_tensor(probs), tw)
        ref, vjp = jax.vjp(lambda z: jloss.cross_entropy_with_probs(z, jnp.asarray(probs), jw),
                           jnp.asarray(logits))
        assert_close(got, ref, atol=TIGHT, rtol=TIGHT, what="cross_entropy_with_probs")
        got.backward(torch.ones_like(got))
        assert_close(tl.grad, vjp(jnp.ones_like(ref))[0], atol=TIGHT, what="ce grad")


def _skin_case(rng, B=2, V=40, J=6):
    """gt_skin rows of a few joints each, sample 0 with 10 padded vertices
    (the draw of 36 anchors runs into them) and sample 1 with one skin for
    all its vertices (every anchor lacks negatives)."""
    skin = np.zeros((B, V, J), np.float32)
    owner = rng.integers(0, J, (B, V))
    skin[np.arange(B)[:, None], np.arange(V)[None], owner] = 1.0
    blend = rng.random((B, V)) < 0.3
    skin[blend] = 0.5 * skin[blend] + 0.5 * np.roll(skin[blend], 1, axis=-1)
    skin[1] = skin[1, :1]
    mask = np.ones((B, V), bool)
    mask[0, 30:] = False
    feat = rng.standard_normal((B, V, 16)).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    return feat, skin, mask


def test_multi_pos_info_nce_matches_jax_on_its_draws():
    """The port's loss on the indices jax.random drew (the JAX package's
    per-sample split and choice calls, repeated by
    `jax_multi_pos_draws`) against multi_pos_info_nce on that key: value and
    feature gradient at TIGHT, with padded anchors and a sample whose
    anchors have no negatives among the cases."""
    feat, skin, mask = _skin_case(np.random.default_rng(22))
    key = jax.random.key(5)
    ref, vjp = jax.vjp(lambda f: jnce.multi_pos_info_nce(key, f, jnp.asarray(skin),
                                                        jnp.asarray(mask), num_sample=36),
                       jnp.asarray(feat))
    draws = [torch.as_tensor(d) for d in F.jax_multi_pos_draws(key, skin, mask, 36)]
    tf = torch.as_tensor(feat).requires_grad_()
    got = tnce.multi_pos_info_nce_drawn(tf, torch.as_tensor(skin), torch.as_tensor(mask), *draws)
    assert_close(got, ref, atol=TIGHT, rtol=TIGHT, what="multi_pos_info_nce")
    got.backward()
    assert_close(tf.grad, vjp(jnp.ones_like(ref))[0], atol=TIGHT, what="feature grad")
    assert float(ref) > 0


def test_multi_pos_draw_obeys_the_masks():
    """The port's own draw: anchors distinct and valid first (padded rows only
    past the valid count), positives of each valid anchor similar to it and
    valid, negatives dissimilar and valid; the loss on the draw is finite and
    zero for the sample without negatives."""
    feat, skin, mask = _skin_case(np.random.default_rng(23))
    g = torch.Generator().manual_seed(0)
    ts, tm = torch.as_tensor(skin), torch.as_tensor(mask)
    ids, pos, neg = tnce.draw_multi_pos(g, ts, tm, 36)
    assert ids.shape == (2, 36) and pos.shape == (2, 36, 10) and neg.shape == (2, 36, 200)
    for b in range(2):
        assert len(set(ids[b].tolist())) == 36
    assert mask[0, ids[0, :30].numpy()].all() and (~mask[0, ids[0, 30:].numpy()]).all()
    s = skin[0, ids[0].numpy()]
    sim = (2.0 - np.abs(s[None] - s[:, None]).sum(-1)) / 2.0
    valid = mask[0, ids[0].numpy()]
    for a in np.flatnonzero(valid):
        assert (sim[a, pos[0, a].numpy()] > 0.9).all() and valid[pos[0, a].numpy()].all()
        assert (sim[a, neg[0, a].numpy()] <= 0.9).all() and valid[neg[0, a].numpy()].all()
    per = [tnce.multi_pos_info_nce_drawn(torch.as_tensor(feat[b:b + 1]), ts[b:b + 1],
                                         tm[b:b + 1], ids[b:b + 1], pos[b:b + 1], neg[b:b + 1])
           for b in range(2)]
    assert np.isfinite(float(per[0])) and float(per[0]) > 0 and float(per[1]) == 0.0


# ---------------------------------------------------------------------------
# DeformPoseStage
# ---------------------------------------------------------------------------

def _datasets():
    jds = jpose.capsule_pose_dataset(**DATA)
    tds = tpose.capsule_pose_dataset(**DATA)
    jds = jpose.PoseDataset(jds.models, tpl_max_degree=12, geo_max_degree=12, buckets=(128,))
    tds = tpose.PoseDataset(tds.models, tpl_max_degree=12, geo_max_degree=12, buckets=(128,))
    return jds, tds


def _counts():
    return (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches,
            tkf.knn_batched.launches, tgcu.plain_edge.launches)


def _deform_step(train_extractor: bool):
    """One DeformPoseStage train step on both sides from the same seeded
    weights (heads included) and batch, FPS from index 0 (JAX rng=None, the
    port's generator=None).  With the extractor frozen the JAX gradient is
    taken over the other parameters only, as optax.multi_transform's
    set_to_zero discards the extractor's."""
    jds, tds = _datasets()
    jb, tb = jds.batch([0, 1], 0, 2), tds.batch([0, 1], 0, 2, device="cpu")
    jstage = jstages.DeformPoseStage(train_extractor=train_extractor)
    model = jdn.DeformNet()
    with F.jax_training_kernels():
        params = F.flax_params(model, 41, jb.mesh, jb.points, True)
        ext = params["corr_extractor"]

        def loss_fn(p):
            full = p if train_extractor else {**p, "corr_extractor": ext}
            return jstage._losses(model.apply({"params": full}, jb.mesh, jb.points, True, None),
                                  jb)

        trained = params if train_extractor else {k: v for k, v in params.items()
                                                  if k != "corr_extractor"}
        (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trained)
    full_grads = dict(jgrads) if train_extractor else {
        **jgrads, "corr_extractor": jax.tree.map(jnp.zeros_like, ext)}
    tx = jstage.make_tx()
    updates, _ = tx.update(full_grads, tx.init(params), params)
    jnew = W.flax_to_state_dict(jax.tree.map(lambda a, u: a + u, params, updates))

    stage = tstages.DeformPoseStage(train_extractor=train_extractor)
    state = stage.init_state(device="cpu")
    state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
    loaded = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    outputs = state.model(tb.mesh, tb.points, train=True)
    stage._losses(outputs, tb)[0].backward()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}
    before = _counts()
    metrics = stage.train_step(state, tb)
    assert _counts() == before          # no kernel launched on the CPU, no plain edge layer
    return dict(jmetrics=jmetrics, jgrads=W.flax_to_state_dict(jgrads), jnew=jnew,
                metrics=metrics, grads=grads, loaded=loaded, state=state, stage=stage,
                batch=tb)


@pytest.fixture(scope="module", params=[False, True], ids=["frozen", "extractor"])
def deform_step(request):
    return _deform_step(request.param)


def test_deform_pose_step_losses_match_jax(deform_step):
    """The step's losses (flow, and infoNCE and the visibility BCE with the
    extractor trained) at the NETWORK tolerance: the flow passes 20 edge
    layers and two kNN selections."""
    keys = set(deform_step["jmetrics"])
    assert keys | {"grad_norm"} == set(deform_step["metrics"])
    for k in keys:
        ref = float(deform_step["jmetrics"][k])
        assert abs(deform_step["metrics"][k] - ref) <= NETWORK[0] * abs(ref), (k, ref)
    assert np.isfinite(deform_step["metrics"]["grad_norm"])


def _rel_l2(got: dict, ref: dict, names) -> float:
    flat = np.concatenate([F.np_(got[n]).ravel() for n in names])
    flat_ref = np.concatenate([np.asarray(ref[n]).ravel() for n in names])
    return float(np.linalg.norm(flat - flat_ref) / np.linalg.norm(flat_ref))


def test_deform_pose_step_grads_match_jax(deform_step):
    """Every trained parameter's gradient (before the clip) at STEP_GRAD and
    the whole gradient vector at STEP_GRAD_TOTAL relative L2; with the
    extractor frozen its parameters take no gradient at all.  With it
    trained, PointNet++'s gradients are held as a group at
    EXTRACTOR_GROUP_L2 and the whole vector at EXTRACTOR_GRAD_TOTAL
    (torch_port_fixtures states why)."""
    grads, ref = deform_step["grads"], deform_step["jgrads"]
    assert set(grads) == set(ref)
    if not deform_step["stage"].train_extractor:
        assert not any(n.startswith("corr_extractor.") for n in grads)
        assert len(deform_step["state"].tx.optimizer.param_groups[0]["params"]) == len(grads)
        total = STEP_GRAD_TOTAL
    else:
        pts = [n for n in grads if n.startswith("corr_extractor.pts_enc.")]
        assert _rel_l2(grads, ref, pts) <= EXTRACTOR_GROUP_L2
        grads = {n: g for n, g in grads.items() if n not in pts}
        total = EXTRACTOR_GRAD_TOTAL
    for n, g in grads.items():
        assert_rel_close(g, ref[n], STEP_GRAD, what=n)
    assert _rel_l2(deform_step["grads"], ref, list(deform_step["grads"])) <= total


def test_deform_pose_step_update_matches_jax(deform_step):
    """Parameters after the step within 2 lr of JAX's, up to the rounding of
    p +- lr (Adam's first step is lr * sign(g), so where a gradient near 0
    takes opposite signs the two sides move apart by 2 lr); with the
    extractor frozen, the extractor's parameters equal the loaded ones bit
    for bit."""
    lr = DEFAULT_CONFIG.train.lr
    frozen = not deform_step["stage"].train_extractor
    for n, p in deform_step["state"].model.named_parameters():
        if frozen and n.startswith("corr_extractor."):
            assert torch.equal(p, deform_step["loaded"][n]), n
        else:
            assert_close(p.detach(), deform_step["jnew"][n], atol=2 * lr, rtol=1e-6, what=n)


def test_deform_pose_steps_lower_the_loss(deform_step, tmp_path):
    """Four more CPU steps on the same batch lower the total loss (the
    frozen extractor still unchanged); the state survives a checkpoint
    round trip; eval_step and infer run the inference forward."""
    stage, state, batch = deform_step["stage"], deform_step["state"], deform_step["batch"]
    losses = [deform_step["metrics"]["total_loss"]]
    for _ in range(4):
        losses.append(stage.train_step(state, batch)["total_loss"])
    assert losses[-1] < losses[0], losses
    if not stage.train_extractor:
        for n, p in state.model.corr_extractor.named_parameters():
            assert torch.equal(p, deform_step["loaded"]["corr_extractor." + n]), n
    path = tckpt.save_checkpoint(state, str(tmp_path), extra={"epoch": 5})
    fresh, meta = tckpt.load_checkpoint(stage.init_state(seed=1, device="cpu"), path)
    assert meta == {"epoch": 5.0} and fresh.step == state.step == 5
    for (n, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n
    ev = stage.eval_step(state, batch)
    assert set(ev) == set(deform_step["jmetrics"]) and np.isfinite(ev["total_loss"])
    flow, vtx_f, pts_f, vis, tau = stage.infer(state, batch)
    assert flow.shape == (2, 128, 3) and vis.shape == (2, 128) and not flow.requires_grad


def test_init_extractor_from_loads_a_corr_state():
    """init_extractor_from puts a CorrPoseStage state's weights into the
    extractor (strictly: a CorrNet of another width is refused), leaves the
    rest and keeps the extractor frozen and out of the optimizer."""
    corr = tstages.CorrPoseStage().init_state(seed=3, device="cpu")
    stage = tstages.DeformPoseStage()
    state = stage.init_state(seed=0, device="cpu")
    rest = {n: p.clone() for n, p in state.model.completing.named_parameters()}
    stage.init_extractor_from(state, corr)
    for (n, p), q in zip(state.model.corr_extractor.named_parameters(),
                         corr.model.parameters()):
        assert torch.equal(p, q) and not p.requires_grad, n
    for n, p in state.model.completing.named_parameters():
        assert torch.equal(p, rest[n]), n
    optimized = {id(p) for g in state.tx.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in optimized for p in state.model.corr_extractor.parameters())
    cfg = dataclasses.replace(DEFAULT_CONFIG, model=dataclasses.replace(
        DEFAULT_CONFIG.model, corr_output_feature=32))
    narrow = tstages.CorrPoseStage(cfg).init_state(device="cpu")
    with pytest.raises(RuntimeError):
        stage.init_extractor_from(state, narrow)
