"""The port's training slice (CorrPoseStage with the edge backward K6)
against the JAX package, on the CPU.

On a CPU tensor each port kernel wrapper runs its plain version; the JAX
side runs its Pallas kernels in interpret mode (`jax_training_kernels`:
every edge layer from 128 wide through the fused forward and backward
kernels, the narrower ones through the package's fp32 XLA tail, as the
port's `narrow_edge`; the kNN through the fused kernel and its VJP).  Inputs come from numpy seeds and
go to both sides.  Tolerances are stated per test with their reasons.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morig_tpu.core.config import DEFAULT_CONFIG
from morig_tpu.data import pose as jpose
from morig_tpu.data import synthetic as jsyn
from morig_tpu.kernels import edge_fused as jef
from morig_tpu.kernels import knn_fused as jkf
from morig_tpu.kernels import neighbors as jnb
from morig_tpu.losses import basic as jloss
from morig_tpu.losses import nce as jnce
from morig_tpu.nn import corrnet as jcn
from morig_tpu.nn import gcu as jgcu
from morig_tpu.nn import mlp as jmlp
from morig_tpu.train import stages as jstages
from morig_tpu.train import trainer as jtrainer
from morig_tpu_torch import weights as W
from morig_tpu_torch.data import pose as tpose
from morig_tpu_torch.data import synthetic as tsyn
from morig_tpu_torch.kernels import edge_fused as tef
from morig_tpu_torch.kernels import knn_fused as tkf
from morig_tpu_torch.kernels import neighbors as tnb
from morig_tpu_torch.losses import basic as tloss
from morig_tpu_torch.losses import nce as tnce
from morig_tpu_torch.nn import corrnet as tcn
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.nn import mlp as tmlp
from morig_tpu_torch.train import checkpoint as tckpt
from morig_tpu_torch.train import stages as tstages
from morig_tpu_torch.train import trainer as ttrainer

import torch_port_fixtures as F
from torch_port_fixtures import (GRAD, GRAD_TOTAL, LAYER, LAYER_GRAD, NETWORK, TIGHT_GRAD,
                                 assert_close, assert_rel_close)

K6_NAMES = ("da", "db_table", "dw2", "db2", "dg1", "dbe1", "dg2", "dbe2")
DATA = dict(num_models=2, num_frames=4, num_points=128, n_lat=7, n_lon=6)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _bwd_inputs(H, seed, B=2, V=256, D=5):
    """Edge-tail inputs with neighbour column 1 a copy of column 0 (exact
    ties in the max), three rows with no valid edge, and a dout."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, V, H)).astype(np.float32)
    b = rng.standard_normal((B, V, H)).astype(np.float32)
    nbr = rng.integers(0, V, (B, V, D))
    mask = rng.random((B, V, D)) < 0.7
    mask[:, :, 0] = True
    mask[:, [7, 18, 29]] = False
    nbr[:, :, 1], mask[:, :, 1] = nbr[:, :, 0], mask[:, :, 0]
    w2 = (rng.standard_normal((H, H)) / np.sqrt(H)).astype(np.float32)
    vecs = [0.1 * rng.standard_normal(H), rng.uniform(0.5, 1.5, H),
            0.1 * rng.standard_normal(H), rng.uniform(0.5, 1.5, H),
            0.1 * rng.standard_normal(H)]
    dout = rng.standard_normal((B, V, H)).astype(np.float32)
    return (a, b, nbr, mask, w2, *(v.astype(np.float32) for v in vecs)), dout


def _k6_both(H, seed, precise):
    args, dout = _bwd_inputs(H, seed)
    a, b, nbr, mask, *rest = args
    t = torch.as_tensor
    got = tef.edge_mlp_bwd_plain(t(a), t(b), t(nbr), t(mask), *map(t, rest), t(dout),
                                 precise=precise)
    ref = jef.fused_edge_mlp_bwd(*map(jnp.asarray, args), jnp.asarray(dout), tile_v=128,
                                 interpret=True, precise=precise)
    return got, ref


@pytest.mark.parametrize("H", [16, 128])
def test_edge_bwd_plain_matches_pallas_interpret(H):
    """K6's plain version against the TPU kernel (interpret) at the kernels'
    bf16 precision, per gradient relative to scale = max(max |ref|, 1):
    mean error <= 1e-5 * scale and fewer than 1e-3 of the entries off by
    more than 1e-3 * scale.  The two sides round h, ds and dx to bf16 from
    fp32 values that differ in the last bits (the TPU kernel takes the LN
    variance in two passes, the port as E[x^2] - mu^2), so a rare element
    lands one bf16 ulp apart."""
    got, ref = _k6_both(H, seed=H, precise=False)
    for name, g, r in zip(K6_NAMES, got, ref):
        g, r = F.np_(g), np.asarray(r)
        assert g.shape == r.shape, name
        scale = max(float(np.abs(r).max()), 1.0)
        err = np.abs(g - r)
        assert err.mean() <= 1e-5 * scale, (name, err.mean(), scale)
        assert (err > 1e-3 * scale).mean() < 1e-3, (name, err.max(), scale)
    assert (F.np_(got[0])[:, [7, 18, 29]] == 0).all()


@pytest.mark.parametrize("H", [16, 128])
def test_edge_bwd_plain_formula_matches_pallas_interpret(H):
    """With fp32 products on both sides (the TPU kernel's `precise=True`),
    the formulas agree to fp32 summation order: 1e-5 * scale."""
    got, ref = _k6_both(H, seed=H + 1, precise=True)
    for name, g, r in zip(K6_NAMES, got, ref):
        scale = max(float(np.abs(np.asarray(r)).max()), 1.0)
        assert_close(g, r, atol=1e-5 * scale, what=name)


# K6's plain version at H = 128 and 256 where both LayerNorms' inputs sit at
# mean 1024 with spread about 1 (a = 1024, exact in bf16; b2 shifted by
# 1024), against the TPU kernel (interpret), whose `_ln_fwd` takes the
# variance in two passes.  Each side resolves such inputs to ~1024 * 2^-24
# in fp32 before rounding h, ds and dx to bf16, so many more elements land a
# bf16 ulp apart than on centred inputs (and route flips follow): measured
# relative L2 up to 1.8e-2 (db_table, dW2, dg1), held at K6_OFFSET_L2;
# max(E[x^2] - E[x]^2, 0) gives 5.5e-2 to 0.24 on every gradient but dbe2.
K6_OFFSET_L2 = 5e-2


@pytest.mark.parametrize("H", [128, 256])
def test_edge_bwd_plain_two_pass_on_offset_inputs(H):
    """Every gradient of K6's plain version within K6_OFFSET_L2 relative L2 of
    the TPU kernel's (interpret) on offset inputs."""
    args, dout = _bwd_inputs(H, seed=H + 2)
    a, b, nbr, mask, w2, b2, *rest = args
    args = (np.full_like(a, 1024.0), b, nbr, mask, w2, b2 + np.float32(1024.0), *rest)
    t = torch.as_tensor
    got = tef.edge_mlp_bwd_plain(*map(t, args), t(dout))
    ref = jef.fused_edge_mlp_bwd(*map(jnp.asarray, args), jnp.asarray(dout), tile_v=128,
                                 interpret=True)
    for name, g, r in zip(K6_NAMES, got, ref):
        g, r = F.np_(g).astype(np.float64), np.asarray(r, np.float64)
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert rel <= K6_OFFSET_L2, (name, rel)


def test_trainable_tail_grads_are_the_plain_backward():
    """On the CPU fused_edge_mlp_trainable's forward is K1's plain version
    on bf16(a), bf16(b), and its gradients are edge_mlp_bwd_plain's exactly;
    no kernel is launched."""
    args, dout = _bwd_inputs(32, seed=3, V=128)
    t = torch.as_tensor
    a, b = t(args[0]).requires_grad_(), t(args[1]).requires_grad_()
    params = [t(x).requires_grad_() for x in args[4:]]
    nbr, mask = t(args[2]), t(args[3])
    before = (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches)
    out = tef.fused_edge_mlp_trainable(a, b, nbr, mask, *params)
    a16, b16 = a.detach().bfloat16(), b.detach().bfloat16()
    assert torch.equal(out, tef.edge_mlp_plain(a16, b16, nbr, mask, *params))
    (out * t(dout)).sum().backward()
    ref = tef.edge_mlp_bwd_plain(a16, b16, nbr, mask, *(p.detach() for p in params), t(dout))
    for name, g, r in zip(K6_NAMES, [a.grad, b.grad] + [p.grad for p in params], ref):
        assert torch.equal(g, r), name
    assert (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches) == before


# ---------------------------------------------------------------------------
# The step's backward, module by module, each fed the same input and dout
# ---------------------------------------------------------------------------

def _grads_close(got: dict, ref: dict, tol, what: str):
    """Every gradient of `ref`, named as the port's state dict, against the
    port's (None where the port's parameter took no gradient)."""
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for n, g in got.items():
        assert g is not None, (what, n)
        assert_rel_close(g, ref[n], tol, what=f"{what}.{n}")


@pytest.mark.parametrize("fin,out", [(3, 32), (32, 64), (64, 256), (256, 512)])
def test_gcu_train_backward_matches_flax(fin, out, monkeypatch):
    """Each of CorrNet's four GCUs in training (its two edge layers 16, 32,
    128 or 256 wide: from 128 through K1 forward + K6 backward here and the
    Pallas trainable kernel in JAX, below it the fp32 tail on both sides;
    the fuse MLP in fp32), fed the same input and the same dout on the
    valid vertices: the output at LAYER, the input's gradient and every
    parameter's gradient at LAYER_GRAD; each side's route counted.  Both
    sides run the same precision, so this holds the edge layers' backward
    without the noise a whole step piles up through 8 layers (the step
    test's GRAD)."""
    entries, _ = F.capsule_inputs(2)
    jm, tm = F.meshes(entries)
    vm = np.asarray(jm.vert_mask)
    rng = np.random.default_rng(out)
    x = rng.standard_normal((2, F.V_PAD, fin)).astype(np.float32)
    dout = rng.standard_normal((2, F.V_PAD, out)).astype(np.float32) * vm[..., None]
    m = jgcu.GCU(out)
    p = F.flax_params(m, fin, jnp.asarray(x), jm)

    def fwd_bwd(p_, x_, d_):
        y, vjp = jax.vjp(lambda pp, xx: m.apply({"params": pp}, xx, jm, True), p_, x_)
        return (y, *vjp(d_))

    with F.jax_training_kernels() as routes:
        ref, jdp, jdx = jax.jit(fwd_bwd)(p, jnp.asarray(x), jnp.asarray(dout))
    half = out // 2
    assert set(routes.pallas) == ({(half, half)} if half >= 128 else set())
    net = F.bridged(lambda: tgcu.GCU(fin, out), W.flax_to_state_dict(p))
    calls, trainable = [], tgcu.fused_edge_mlp_trainable
    narrow, narrow_trainable = [], tgcu.narrow_edge_trainable
    monkeypatch.setattr(tgcu, "fused_edge_mlp_trainable",
                        lambda *a, **k: calls.append(1) or trainable(*a, **k))
    monkeypatch.setattr(tgcu, "narrow_edge_trainable",
                        lambda *a, **k: narrow.append(1) or narrow_trainable(*a, **k))
    xt = torch.as_tensor(x).requires_grad_()
    y = net(xt, tm, train=True)
    y.backward(torch.as_tensor(dout))
    assert (len(calls), len(narrow)) == ((2, 0) if half >= 128 else (0, 2))
    assert_rel_close(y, ref, LAYER, vm, f"GCU{out}")
    assert_rel_close(xt.grad, jdx, LAYER_GRAD, vm, f"GCU{out} dx")
    _grads_close({n: q.grad for n, q in net.named_parameters()}, W.flax_to_state_dict(jdp),
                 LAYER_GRAD, f"GCU{out}")


def test_mesh_encoder_tail_train_backward_matches_flax():
    """The mesh encoder after its GCUs (vtx_mlp_glb, the masked global max,
    the vtx_mlp head, the L2 norm) in training, fed the same skips and
    dout: fp32 on both sides, so the gradients of the skips and of every
    parameter agree to TIGHT_GRAD."""
    entries, _ = F.capsule_inputs(2)
    jm, tm = F.meshes(entries)
    vm = np.asarray(jm.vert_mask)
    rng = np.random.default_rng(8)
    skips = rng.standard_normal((2, F.V_PAD, 864)).astype(np.float32)
    dout = rng.standard_normal((2, F.V_PAD, 64)).astype(np.float32) * vm[..., None]
    verts = np.asarray(jm.verts)
    jglb, jhead = jmlp.MLP([1024]), jmlp.MLPHead([1024, 256], 64)
    pg = F.flax_params(jglb, 1, jnp.asarray(skips))
    ph = F.flax_params(jhead, 2, jnp.zeros((2, F.V_PAD, 1024 + 3 + 864)))

    def jtail(pg_, ph_, s_):
        x5 = jglb.apply({"params": pg_}, s_, jm.vert_mask, True)
        glb = jnp.broadcast_to(jnb.masked_max(x5, jm.vert_mask, axis=1)[:, None], x5.shape)
        x6 = jnp.concatenate([glb, verts, s_], -1)
        return jcn.l2_normalize(jhead.apply({"params": ph_}, x6, jm.vert_mask, True))

    _, vjp = jax.vjp(jtail, pg, ph, jnp.asarray(skips))
    jdg, jdh, jds = vjp(jnp.asarray(dout))
    glb_net = F.bridged(lambda: tmlp.MLP(864, [1024]), W.flax_to_state_dict(pg))
    head = F.bridged(lambda: tmlp.MLPHead(1024 + 3 + 864, [1024, 256], 64),
                     W.flax_to_state_dict(ph))
    st = torch.as_tensor(skips).requires_grad_()
    x5 = glb_net(st, train=True)
    glb = tnb.masked_max(x5, tm.vert_mask, dim=1)[:, None].expand(-1, F.V_PAD, -1)
    x6 = torch.cat([glb, tm.verts, st], -1)
    tcn.l2_normalize(head(x6, train=True)).backward(torch.as_tensor(dout))
    assert_rel_close(st.grad, jds, TIGHT_GRAD, vm, "skips")
    for net, jd, what in ((glb_net, jdg, "vtx_mlp_glb"), (head, jdh, "vtx_mlp")):
        _grads_close({n: q.grad for n, q in net.named_parameters()}, W.flax_to_state_dict(jd),
                     TIGHT_GRAD, what)


def test_corrnet_point_branch_and_losses_backward_match_flax():
    """CorrNet's step from a given mesh embedding on (flax's `vtx_f`): the
    PointNet++ branch in training (plain gathers, FPS from index 0), the
    vismask 1-NN through K2 with its autograd, the vismask head, the
    temperature and the step's losses, backward from total_loss.  fp32
    everywhere but K2's bf16 similarity, which only selects, so the
    embedding's and every parameter's gradient agree to TIGHT_GRAD."""
    jds, tds = _datasets()
    jb, tb = jds.batch([0, 1], 0, 2), tds.batch([0, 1], 0, 2, device="cpu")
    rng = np.random.default_rng(9)
    vtx_f = rng.standard_normal((2, 128, 64)).astype(np.float32)
    vtx_f /= np.linalg.norm(vtx_f, axis=-1, keepdims=True)
    model = jcn.CorrNet()
    jstage = jstages.CorrPoseStage()
    with F.jax_training_kernels():
        params = F.flax_params(model, 32, jb.mesh, jb.points, True, True)

        def loss_fn(p, v):
            return jstage._losses(model.apply({"params": p}, jb.mesh, jb.points, True, True,
                                              None, v), jb, True)

        (jtotal, _), (jgp, jgv) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(vtx_f))
    stage = tstages.CorrPoseStage()
    net = F.bridged(tcn.CorrNet, W.flax_to_state_dict(params))
    vt = torch.as_tensor(vtx_f).requires_grad_()
    total, _ = stage._losses(net(tb.mesh, tb.points, True, True, vtx_f=vt), tb, True)
    total.backward()
    F.assert_close(total, jtotal, atol=0, rtol=1e-5, what="total_loss")
    assert_rel_close(vt.grad, jgv, TIGHT_GRAD, np.asarray(jb.mesh.vert_mask), "vtx_f")
    ref = {n: g for n, g in W.flax_to_state_dict(jgp).items() if not n.startswith("mesh_enc.")}
    got = {n: q.grad for n, q in net.named_parameters() if not n.startswith("mesh_enc.")}
    assert all(q.grad is None for n, q in net.named_parameters() if n.startswith("mesh_enc."))
    _grads_close(got, ref, TIGHT_GRAD, "CorrNet")


# ---------------------------------------------------------------------------
# K2's autograd, losses, optimizer
# ---------------------------------------------------------------------------

def test_knn_gather_grads_match_jax_vjp():
    """Gradients of <score, ws> + <gathered, wg> through K2 (plain version +
    autograd) against jax.grad through the fused kNN's custom VJP
    (interpret): the selection is identical, the VJP is fp32 on both sides,
    so 1e-5."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 64, 64)).astype(np.float32)
    c = rng.standard_normal((2, 128, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    mask = rng.random((2, 128)) < 0.8
    vals = rng.standard_normal((2, 128, 5)).astype(np.float32)
    ws = rng.standard_normal((2, 64, 3)).astype(np.float32)
    wg = rng.standard_normal((2, 64, 3, 5)).astype(np.float32)

    def jloss_fn(q_, c_, v_):
        _, score, gathered = jkf.knn_batched(q_, c_, 3, jnp.asarray(mask), gather_values=v_)
        return jnp.sum(score * ws) + jnp.sum(gathered * wg)

    jkf.set_knn_impl("fused")
    try:
        jg = jax.grad(jloss_fn, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(c),
                                                   jnp.asarray(vals))
    finally:
        jkf.set_knn_impl("auto")
    tq, tc, tv = (torch.as_tensor(x).requires_grad_() for x in (q, c, vals))
    _, score, gathered = tkf.knn_batched(tq, tc, 3, torch.as_tensor(mask), gather_values=tv)
    ((score * torch.as_tensor(ws)).sum() + (gathered * torch.as_tensor(wg)).sum()).backward()
    for name, g, r in zip(("query", "cand", "values"), (tq.grad, tc.grad, tv.grad), jg):
        assert_close(g, r, atol=1e-5, what=name)


def test_losses_match_jax():
    """info_nce (with padded rows and columns, a sample with no valid row),
    bce_with_logits and masked_l1 / masked_mse, fp32 on both sides: 1e-6."""
    rng = np.random.default_rng(5)
    B, V, P, N, C = 2, 40, 30, 16, 8
    vf = rng.standard_normal((B, V, C)).astype(np.float32)
    pf = rng.standard_normal((B, P, C)).astype(np.float32)
    vf /= np.linalg.norm(vf, axis=-1, keepdims=True)
    pf /= np.linalg.norm(pf, axis=-1, keepdims=True)
    v2p = np.stack([rng.integers(0, V, (B, N)), rng.integers(0, P, (B, N))], -1)
    p2v = np.stack([rng.integers(0, P, (B, N)), rng.integers(0, V, (B, N))], -1)
    v2pm, p2vm = rng.random((B, N)) < 0.7, rng.random((B, N)) < 0.7
    p2vm[1] = False
    vm, pm = rng.random((B, V)) < 0.9, rng.random((B, P)) < 0.9
    args = (vf, pf, v2p, v2pm, p2v, p2vm, vm, pm)
    ref = jnce.info_nce(*map(jnp.asarray, args), jnp.float32(0.07))
    got = tnce.info_nce(*map(torch.as_tensor, args), torch.tensor(0.07))
    assert_close(got, ref, atol=1e-6, rtol=1e-6, what="info_nce")
    logits = 3 * rng.standard_normal((B, V)).astype(np.float32)
    targets = (rng.random((B, V)) < 0.5).astype(np.float32)
    for mask in (None, vm):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.as_tensor(mask)
        assert_close(tloss.bce_with_logits(torch.as_tensor(logits), torch.as_tensor(targets), tm),
                     jloss.bce_with_logits(jnp.asarray(logits), jnp.asarray(targets), jm),
                     atol=1e-6, rtol=1e-6, what="bce")
    pred, tgt = rng.standard_normal((2, B, V, 3)).astype(np.float32)
    for tfn, jfn in ((tloss.masked_l1, jloss.masked_l1), (tloss.masked_mse, jloss.masked_mse)):
        assert_close(tfn(*map(torch.as_tensor, (pred, tgt, vm))),
                     jfn(*map(jnp.asarray, (pred, tgt, vm))), atol=1e-6, rtol=1e-6)


def test_multistep_adam_matches_optax_chain():
    """Five steps of fixed gradients from the same parameters: the clip
    triggers on some steps (global norm above 10) and not on others, and
    the milestone (step 2) cuts the learning rate; parameters agree to
    1e-6."""
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (20.0, 0.5, 30.0, 1.0, 2.0)]
    tx = jtrainer.multistep_adam(1e-2, (2,), 0.1, 1e-2, steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in params.items()}
    ttx = ttrainer.multistep_adam(list(tp.values()), 1e-2, (2,), 0.1, 1e-2, steps_per_epoch=1)
    norms = []
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.zero_grad()
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k].copy())
        norms.append(float(ttx.step()))
        for k in params:
            assert_close(tp[k].detach(), jp[k], atol=1e-6, what=k)
    assert norms[0] > 10 and norms[1] < 10
    assert ttx.scheduler.get_last_lr() == [pytest.approx(1e-3)]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partial", [True, False])
def test_capsule_sequence_outputs_match_jax(partial):
    """Every array of make_capsule_sequence, the correspondences and
    visibility included, equals the JAX package's."""
    kw = dict(num_frames=5, num_points=64, partial=partial, seed=2, n_lat=7, n_lon=6)
    ref, got = jsyn.make_capsule_sequence(**kw), tsyn.make_capsule_sequence(**kw)
    assert set(got) == set(ref)
    for key in ("vtx_traj", "pts_traj", "corr_v2p", "corr_p2v", "vismask", "tpl_edges",
                "geo_edges"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert ref["vismask"].min() == (0.0 if partial else 1.0)


def _datasets():
    jds = jpose.capsule_pose_dataset(**DATA)
    tds = tpose.capsule_pose_dataset(**DATA)
    jds = jpose.PoseDataset(jds.models, tpl_max_degree=12, geo_max_degree=12, buckets=(128,))
    tds = tpose.PoseDataset(tds.models, tpl_max_degree=12, geo_max_degree=12, buckets=(128,))
    return jds, tds


def test_pose_dataset_batches_match_jax():
    """PoseDataset.batch array for array, and the epoch schedule draw for
    draw from the same numpy generator (bucketed, ragged tail cycled)."""
    jds, tds = _datasets()
    jb, tb = jds.batch([0, 1], 0, 2), tds.batch([0, 1], 0, 2, device="cpu")
    pairs = [(jb.mesh, tb.mesh, ("verts", "vert_mask", "tpl_nbr", "tpl_mask", "geo_nbr",
                                 "geo_mask")),
             (jb.points, tb.points, ("pts", "pts_mask")),
             (jb.corr, tb.corr, ("v2p", "v2p_mask", "p2v", "p2v_mask")),
             (jb, tb, ("vismask", "gt_flow"))]
    for jx, tx, keys in pairs:
        for k in keys:
            got = getattr(tx, k)
            assert got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jx, k)), err_msg=k)
    models = jds.models + jds.models[:1]
    jds3 = jpose.PoseDataset(models, buckets=(128,))
    tds3 = tpose.PoseDataset(tds.models + tds.models[:1], buckets=(128,))
    for train in (True, False):
        js = jds3.epoch_schedule(np.random.default_rng(7), 2, "deformingthings", False, train)
        ts = tds3.epoch_schedule(np.random.default_rng(7), 2, "deformingthings", False, train)
        assert ts == js


# ---------------------------------------------------------------------------
# CorrPoseStage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corr_step():
    """One CorrPoseStage train step on both sides from the same seeded
    weights (heads included) and batch, vismask branch on, FPS from index 0
    (JAX rng=None, the port's generator=None)."""
    jds, tds = _datasets()
    jb, tb = jds.batch([0, 1], 0, 2), tds.batch([0, 1], 0, 2, device="cpu")
    jstage = jstages.CorrPoseStage()
    model = jcn.CorrNet()
    with F.jax_training_kernels() as routes:
        params = F.flax_params(model, 31, jb.mesh, jb.points, True, True)

        def loss_fn(p):
            outputs = model.apply({"params": p}, jb.mesh, jb.points, True, True, None)
            return jstage._losses(outputs, jb, True)

        (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jstage.make_tx()
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    stage = tstages.CorrPoseStage()
    stage.train_vismask = True
    state = stage.init_state(device="cpu")
    state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
    # the gradients before the step's in-place clip, as jax.grad gives them
    trainable, kernel_calls = tgcu.fused_edge_mlp_trainable, []
    narrow_trainable, narrow_calls = tgcu.narrow_edge_trainable, []

    def counted(*a, **k):
        kernel_calls.append(tuple(a[4].shape))
        return trainable(*a, **k)

    def counted_narrow(*a, **k):
        narrow_calls.append(tuple(a[4].shape))
        return narrow_trainable(*a, **k)

    tgcu.fused_edge_mlp_trainable, tgcu.narrow_edge_trainable = counted, counted_narrow
    try:
        outputs = state.model(tb.mesh, tb.points, train=True, train_vismask=True)
    finally:
        tgcu.fused_edge_mlp_trainable, tgcu.narrow_edge_trainable = trainable, narrow_trainable
    narrow = len(narrow_calls)
    stage._losses(outputs, tb, True)[0].backward()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    before = (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches,
              tkf.knn_batched.launches)
    metrics = stage.train_step(state, tb)
    assert before == (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches,
                      tkf.knn_batched.launches)
    return dict(jmetrics=jmetrics, jgrads=W.flax_to_state_dict(jgrads),
                jnew=W.flax_to_state_dict(jnew), metrics=metrics, grads=grads, state=state,
                stage=stage, batch=tb, routes=(set(routes.pallas), kernel_calls, narrow))


def test_corr_pose_step_losses_match_jax(corr_step):
    """corr_loss, vis_loss and total_loss at the NETWORK tolerance (the
    outputs pass 8 edge layers; torch_port_fixtures states its reasons)."""
    for k in ("corr_loss", "vis_loss", "total_loss"):
        ref = float(corr_step["jmetrics"][k])
        assert abs(corr_step["metrics"][k] - ref) <= NETWORK[0] * abs(ref), (k, ref)
    assert np.isfinite(corr_step["metrics"]["grad_norm"])


def test_corr_pose_step_grads_match_jax(corr_step):
    """Every parameter's gradient (before the clip) at the GRAD tolerance,
    relative to that gradient's mean and max magnitude, and the whole
    gradient vector to GRAD_TOTAL relative L2 (torch_port_fixtures states
    both with the measured errors).  The mesh encoder's 128- and 256-wide
    edge layers took K1 + K6 here and the Pallas trainable kernel in JAX,
    its four 16- and 32-wide ones the fp32 tail on both sides."""
    jax_pallas, kernel_calls, narrow = corr_step["routes"]
    assert jax_pallas == {(128, 128), (256, 256)}
    assert sorted(kernel_calls) == [(128, 128)] * 2 + [(256, 256)] * 2 and narrow == 4
    grads, ref = corr_step["grads"], corr_step["jgrads"]
    assert set(grads) == set(ref)
    for n, g in grads.items():
        assert_rel_close(g, ref[n], GRAD, what=n)
    flat = np.concatenate([F.np_(grads[n]).ravel() for n in grads])
    flat_ref = np.concatenate([np.asarray(ref[n]).ravel() for n in grads])
    assert np.linalg.norm(flat - flat_ref) <= GRAD_TOTAL * np.linalg.norm(flat_ref)


def test_corr_pose_step_update_matches_jax(corr_step):
    """Parameters after the step within 2 lr of JAX's: Adam's first step is
    lr * sign(g) wherever |g| is well above eps, so a near-zero gradient may
    move the two sides in opposite directions."""
    lr = DEFAULT_CONFIG.train.lr
    for n, p in corr_step["state"].model.named_parameters():
        assert_close(p.detach(), corr_step["jnew"][n], atol=2 * lr, what=n)


def test_corr_pose_steps_lower_the_loss(corr_step, tmp_path):
    """Three more CPU steps on the same batch lower the total loss; the
    state survives a checkpoint round trip and the best copy is written."""
    stage, state, batch = corr_step["stage"], corr_step["state"], corr_step["batch"]
    losses = [corr_step["metrics"]["total_loss"]]
    for _ in range(3):
        losses.append(stage.train_step(state, batch)["total_loss"])
    assert losses[-1] < losses[0], losses
    path = tckpt.save_checkpoint(state, str(tmp_path), is_best=True, extra={"epoch": 4})
    fresh = stage.init_state(seed=1, device="cpu")
    fresh, meta = tckpt.load_checkpoint(fresh, path)
    assert meta == {"epoch": 4.0} and fresh.step == state.step == 4
    for (n, p), q in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n
    assert (tmp_path / "model_best.pt").exists()
    ev = stage.eval_step(state, batch)
    assert set(ev) == {"corr_loss", "vis_loss", "total_loss"} and np.isfinite(ev["total_loss"])
    vtx_f, pts_f, vis, tau = stage.infer(state, batch)
    assert vtx_f.shape == (2, 128, 64) and pts_f.shape == (2, 128, 64)
    assert vis.shape == (2, 128, 1) and not vtx_f.requires_grad
    torch.testing.assert_close(vtx_f.norm(dim=-1), torch.ones(2, 128))


def test_run_epochs_trains_and_checkpoints(tmp_path):
    """The epoch loop at a tiny size: one epoch of one training batch (random
    FPS starts from a generator) and one validation batch, a checkpoint and
    a best copy, and the JSONL metric log."""
    _, tds = _datasets()
    cfg = dataclasses.replace(tstages.DEFAULT_CONFIG,
                              train=dataclasses.replace(tstages.DEFAULT_CONFIG.train,
                                                        vis_branch_start_epoch=0))
    stage = tstages.CorrPoseStage(cfg)
    state = stage.init_state(device="cpu")
    logger = ttrainer.MetricLogger(str(tmp_path / "log"))
    state, best = ttrainer.run_epochs(
        stage, state,
        lambda epoch: tds.epoch_batches(np.random.default_rng(epoch), 2, "deformingthings",
                                        False, device="cpu"),
        lambda: tds.epoch_batches(np.random.default_rng(0), 2, "deformingthings", False,
                                  train=False, device="cpu"),
        None, epochs=1, checkpoint_dir=str(tmp_path / "ckpt"), logger=logger,
        generator=torch.Generator().manual_seed(3))
    logger.close()
    assert best == 0 and state.step == 1 and stage.train_vismask
    assert (tmp_path / "ckpt" / "checkpoint.pt").exists()
    assert (tmp_path / "ckpt" / "model_best.pt.json").exists()
    assert len((tmp_path / "log" / "metrics.jsonl").read_text().splitlines()) == 2
