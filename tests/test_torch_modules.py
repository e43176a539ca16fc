"""Every ported network module against flax `apply` on the same weights.

Weights: seeded random values for every flax parameter, heads included,
bridged to torch with morig_tpu_torch.weights (load_state_dict strict).
The JAX side runs its Pallas kernels in interpret mode (the kNN and row
gather with bf16 similarity, the edge tail with fp32 LayerNorms), at the
port's precision.

Tolerances:
  * TIGHT (fp32 on both sides: MLPs, PointNet++, neighbor search,
    clustering): a few 1e-4 at most, from fp32 sums in another order and the
    TPU gather's hi/lo reconstruction (~2^-17 relative).
  * LAYER and NETWORK (outputs behind GCU edge layers), relative to the
    reference's mean and max magnitude: the reasons and the measured errors
    are stated in torch_port_fixtures.

Where a discrete selection (kNN, radius top-k, FPS, thresholds) sits below
bf16 noise, the JAX intermediate is handed to the port so the selection
runs on identical features.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.core import batch as JB
from morig_tpu.geometry import clustering as jcl
from morig_tpu.kernels import neighbors as jnb
from morig_tpu.nn import bonenet as jbn
from morig_tpu.nn import deformnet as jdn
from morig_tpu.nn import gcu as jgcu
from morig_tpu.nn import mlp as jmlp
from morig_tpu.nn import rignet as jrn
from morig_tpu_torch import weights as W
from morig_tpu_torch.core import batch as TB
from morig_tpu_torch.geometry import clustering as tcl
from morig_tpu_torch.kernels import neighbors as tnb
from morig_tpu_torch.nn import bonenet as tbn
from morig_tpu_torch.nn import corrnet as tcn
from morig_tpu_torch.nn import deformnet as tdn
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.nn import mlp as tmlp
from morig_tpu_torch.nn import rignet as trn

import torch_port_fixtures as F
from torch_port_fixtures import LAYER, NETWORK, TIGHT, assert_rel_close


@pytest.fixture(scope="module")
def fixture():
    entries, frames = F.capsule_inputs(2)
    jm, tm = F.meshes(entries)
    pts = np.stack([f[0] for f in frames])                    # (2, P, 3)
    jp = JB.PointBatch(jnp.asarray(pts), jnp.ones(pts.shape[:2], bool))
    tp = TB.PointBatch(torch.as_tensor(pts), torch.ones(pts.shape[:2], dtype=torch.bool))
    return dict(entries=entries, jm=jm, tm=tm, jp=jp, tp=tp,
                vm=np.asarray(jm.vert_mask))


@pytest.fixture(scope="module")
def deform_run(fixture):
    """One flax DeformNet forward with every sub-module output captured."""
    m = jdn.DeformNet()
    jm, jp = fixture["jm"], fixture["jp"]
    with F.jax_fused_kernels():
        p = F.flax_params(m, 4, jm, jp, False, None)
        out, state = jax.jit(lambda p_, jm_, jp_: m.apply(
            {"params": p_}, jm_, jp_, False, None, capture_intermediates=True,
            mutable=["intermediates"]))(p, jm, jp)
    inter = state["intermediates"]

    def get(*path):
        node = inter
        for k in path:
            node = node[k]
        return node["__call__"][0]

    return dict(params=p, out=out, get=get)


def test_mlp_and_head_match_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 50, 24)).astype(np.float32)
    head = jmlp.MLPHead([64, 32], 5, zero_init=True)
    p = F.flax_params(head, 1, jnp.asarray(x))
    ref = head.apply({"params": p}, jnp.asarray(x))
    got = F.bridged(lambda: tmlp.MLPHead(24, [64, 32], 5, zero_init=True),
                    W.flax_to_state_dict(p))(torch.as_tensor(x))
    F.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H", [32, 256])
def test_gcu_matches_flax(fixture, H):
    rng = np.random.default_rng(H)
    x = rng.standard_normal((2, F.V_PAD, 64)).astype(np.float32)
    m = jgcu.GCU(H)
    p = F.flax_params(m, H, jnp.asarray(x), fixture["jm"])
    with F.jax_fused_kernels():
        ref = m.apply({"params": p}, jnp.asarray(x), fixture["jm"])
    net = F.bridged(lambda: tgcu.GCU(64, H), W.flax_to_state_dict(p))
    assert_rel_close(net(torch.as_tensor(x), fixture["tm"]), ref, LAYER, fixture["vm"], f"GCU{H}")


@pytest.mark.parametrize("H,dp", [(64, 16), (256, 64)])
def test_gcu_motion_matches_flax(fixture, H, dp):
    rng = np.random.default_rng(H + dp)
    x = rng.standard_normal((2, F.V_PAD, 32)).astype(np.float32)
    pos = np.asarray(fixture["jm"].verts)
    m = jgcu.GCUMotion(H, dim_pos_feat=dp)
    p = F.flax_params(m, dp, jnp.asarray(pos), jnp.asarray(x), fixture["jm"])
    with F.jax_fused_kernels():
        ref = m.apply({"params": p}, jnp.asarray(pos), jnp.asarray(x), fixture["jm"])
    net = F.bridged(lambda: tgcu.GCUMotion(3, 32, H, dp), W.flax_to_state_dict(p))
    got = net(torch.as_tensor(pos), torch.as_tensor(x), fixture["tm"])
    assert_rel_close(got, ref, LAYER, fixture["vm"], f"GCUMotion{H}")


def test_gcu_windowed_matches_flax(monkeypatch):
    """A GCU on a V=384 mesh batch local at tile 128: the port's windowed
    edge layers (mesh.edge_tile = 128) against flax with
    set_edge_impl("windowed") and set_edge_tile(128), which reaches the JAX
    package's windowed Pallas kernel (interpret), at LAYER."""
    from morig_tpu.kernels import edge_fused as jef
    from morig_tpu_torch.data.synthetic import capsule_batch

    entries, _ = capsule_batch(2, 1, 64, 384, 12, n_lat=17, n_lon=16, seed=3)
    assert tgcu.auto_select_edge_impl(entries, tile_v=128) == "windowed"
    jm = JB.stack_meshes(entries)
    tm = TB.stack_meshes(entries, device="cpu", edge_tile=128)
    x = np.random.default_rng(384).standard_normal((2, 384, 32)).astype(np.float32)
    m = jgcu.GCU(64)
    p = F.flax_params(m, 384, jnp.asarray(x), jm)
    traced = []
    windowed = jef.fused_edge_mlp_windowed
    monkeypatch.setattr(jef, "fused_edge_mlp_windowed",
                        lambda *a, **k: traced.append(k["tile_v"]) or windowed(*a, **k))
    impl, tile = jgcu.get_edge_impl(), jgcu.get_edge_tile()
    jgcu.set_edge_impl("windowed")
    jgcu.set_edge_tile(128)
    try:
        with F.jax_fused_kernels():
            ref = m.apply({"params": p}, jnp.asarray(x), jm)
    finally:
        jgcu.set_edge_impl(impl)
        jgcu.set_edge_tile(tile)
    assert traced == [128, 128]
    net = F.bridged(lambda: tgcu.GCU(32, 64), W.flax_to_state_dict(p))
    assert_rel_close(net(torch.as_tensor(x), tm), ref, LAYER, np.asarray(jm.vert_mask),
                     "windowed GCU")


def test_neighbor_search_matches_jax():
    """pairwise distances, euclidean kNN, exact radius grouping, FPS and the
    masked max, on clouds with padding."""
    rng = np.random.default_rng(3)
    pts = rng.random((2, 128, 3)).astype(np.float32)
    cent = pts[:, :40]
    mask = rng.random((2, 128)) < 0.85
    t = torch.as_tensor
    F.assert_close(tnb.pairwise_sqdist(t(cent), t(pts)),
                   jax.vmap(jnb.pairwise_sqdist)(cent, pts), atol=1e-6)
    idx, sc = tnb.knn(t(cent), t(pts), 3, t(mask))
    jidx, jsc = jax.vmap(lambda q, c, m: jnb.knn(q, c, 3, m))(cent, pts, mask)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    F.assert_close(sc, jsc, atol=1e-6)
    jnb.set_topk_mode("exact")
    try:
        gidx, gval = tnb.radius_group(t(cent), t(pts), 0.2, 16, t(mask))
        jgidx, jgval = jax.vmap(lambda c, p, m: jnb.radius_group(c, p, 0.2, 16, m))(
            cent, pts, mask)
    finally:
        jnb.set_topk_mode("auto")
    np.testing.assert_array_equal(gval.numpy(), np.asarray(jgval))
    np.testing.assert_array_equal(np.where(gval.numpy(), gidx.numpy(), -1),
                                  np.where(np.asarray(jgval), np.asarray(jgidx), -1))
    f = tnb.fps(t(pts), 32, t(mask))
    jf = jax.vmap(lambda p, m: jnb.fps(p, 32, m))(pts, mask)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    x = rng.standard_normal((2, 128, 5)).astype(np.float32)
    m2 = mask.copy()
    m2[1] = False
    F.assert_close(tnb.masked_max(t(x), t(m2), dim=1), jnb.masked_max(x, m2, axis=1), atol=0)


@pytest.mark.parametrize("sample_rows", [0, 64])
def test_clustering_matches_jax(sample_rows):
    """Bandwidth (bisection, with and without the strided row sample),
    mean-shift with its per-sample convergence freeze, density counts."""
    rng = np.random.default_rng(sample_rows)
    shifted = (rng.random((2, 128, 3)) * 0.3).astype(np.float32)
    attn = rng.random((2, 128)).astype(np.float32)
    vm = np.ones((2, 128), bool)
    vm[1, 90:] = False
    ref = jcl.select_and_cluster(jnp.asarray(shifted), jnp.asarray(attn), jnp.asarray(vm),
                                 None, None, None, quantile=0.04, num_iter=30,
                                 attn_threshold=0.1, symmetrize=True, has_vox=False,
                                 sample_rows=sample_rows)
    got = tcl.select_and_cluster(torch.as_tensor(shifted), torch.as_tensor(attn),
                                 torch.as_tensor(vm), 0.04, 30, 0.1, sample_rows)
    moved, bw, counts, attn2, sel2 = (F.np_(g) for g in got)
    F.assert_close(bw, ref[1], atol=0, rtol=1e-5, what="bandwidth")
    F.assert_close(moved, ref[0], atol=TIGHT, what="moved")
    np.testing.assert_array_equal(counts, np.asarray(ref[2]))
    F.assert_close(attn2, ref[3], atol=1e-6)
    np.testing.assert_array_equal(sel2, np.asarray(ref[4]))


def test_mesh_encoder_and_gcus_match_flax(fixture, deform_run):
    """MeshEncoder end to end (four GCUs, two MLP stacks, a global max: a
    network, so NETWORK), and each of its GCUs and MLP stacks fed the flax
    input (LAYER)."""
    get, p = deform_run["get"], deform_run["params"]["corr_extractor"]
    net = F.bridged(tdn.DeformNet, W.flax_to_state_dict(deform_run["params"]))
    enc = net.corr_extractor.mesh_enc
    vm, tm = fixture["vm"], fixture["tm"]
    assert_rel_close(enc(tm), get("corr_extractor", "mesh_enc"), NETWORK, vm, "MeshEncoder")
    verts = torch.as_tensor(np.asarray(fixture["jm"].verts))
    x, skips = verts, []
    for i in range(1, 5):
        ref = get("corr_extractor", "mesh_enc", f"vtx_gcu_{i}")
        assert_rel_close(getattr(enc, f"vtx_gcu_{i}")(x, tm), ref, LAYER, vm, f"vtx_gcu_{i}")
        x = torch.as_tensor(np.asarray(ref))
        skips.append(x)
    skips = torch.cat(skips, -1)
    glb_ref = get("corr_extractor", "mesh_enc", "vtx_mlp_glb")
    assert_rel_close(enc.vtx_mlp_glb(skips), glb_ref, LAYER, vm, "vtx_mlp_glb")
    glb = tnb.masked_max(torch.as_tensor(np.asarray(glb_ref)), tm.vert_mask, dim=1)
    x6 = torch.cat([glb[:, None, :].expand(-1, skips.shape[1], -1), verts, skips], -1)
    assert_rel_close(enc.vtx_mlp(x6), get("corr_extractor", "mesh_enc", "vtx_mlp"), LAYER, vm,
                     "vtx_mlp")
    assert set(p) == {"mesh_enc", "pts_enc", "lin_vismask", "temperature"}


def test_point_encoder_matches_flax(fixture, deform_run):
    net = F.bridged(tdn.DeformNet, W.flax_to_state_dict(deform_run["params"]))
    got = net.corr_extractor.pts_enc(fixture["tp"])
    F.assert_close(got, deform_run["get"]("corr_extractor", "pts_enc"), atol=TIGHT)


def test_corrnet_and_deformnet_match_flax(fixture, deform_run):
    """CorrNet (vismask head over the K2 1-NN) and DeformNet (voting and
    completion over K2, GCNDeform), both fed the flax mesh embedding.  For
    the flow the point embedding and vismask logits are the flax ones too:
    an fp32-level difference can flip a near-tie in the voting kNN or move
    a vertex across the 0.5 visibility threshold, and with random weights
    the similarity-weighted vote divides by sums near 0 for some vertices,
    which GCNDeform then spreads over the mesh."""
    net = F.bridged(tdn.DeformNet, W.flax_to_state_dict(deform_run["params"]))
    get, vm = deform_run["get"], fixture["vm"]
    vtx_f = torch.as_tensor(np.asarray(get("corr_extractor", "mesh_enc")))
    _, pts_f, vis_logits, tau = net.corr_extractor(fixture["tm"], fixture["tp"], vtx_f=vtx_f)
    j_vtx, j_pts, j_vis, j_tau = get("corr_extractor")
    F.assert_close(pts_f, j_pts, atol=TIGHT)
    F.assert_close(vis_logits, j_vis, atol=2e-3, rtol=1e-3, what="vismask logits")
    assert float(tau) == pytest.approx(float(j_tau))
    net.corr_extractor.lin_vismask.forward = lambda *_: torch.as_tensor(np.asarray(j_vis))
    net.corr_extractor.pts_enc.forward = lambda *_: torch.as_tensor(np.asarray(j_pts))
    flow, _, _, vis, _ = net(fixture["tm"], fixture["tp"], vtx_f=vtx_f)
    j_flow, _, _, j_vis01, _ = deform_run["out"]
    F.assert_close(vis, j_vis01, atol=1e-6, what="vismask")
    assert_rel_close(flow, j_flow, NETWORK, vm, "DeformNet flow")
    assert np.abs(F.np_(flow)[vm]).mean() > 0.1         # random heads: flow is not 0


@pytest.fixture(scope="module")
def flow_input(fixture):
    rng = np.random.default_rng(11)
    return (0.1 * rng.standard_normal((2, F.V_PAD, 3 * F.T))).astype(np.float32)


@pytest.mark.parametrize("name", ["joint", "mask"])
def test_joint_and_mask_nets_match_flax(fixture, flow_input, name):
    jcls, tcls, bridge = {
        "joint": (jrn.JointNetMotion, trn.JointNetMotion, W.flax_to_state_dict),
        "mask": (jrn.MaskNetMotion, trn.MaskNetMotion, W.flax_to_state_dict)}[name]
    m = jcls()
    p = F.flax_params(m, 6, jnp.asarray(flow_input), fixture["jm"])
    with F.jax_fused_kernels():
        motion_all, aggr, out = m.apply({"params": p}, jnp.asarray(flow_input), fixture["jm"])
    net = F.bridged(tcls, bridge(p))
    t_all, t_aggr, t_out = net(torch.as_tensor(flow_input), fixture["tm"])
    vm = fixture["vm"]
    assert_rel_close(t_all, motion_all, NETWORK, vm, f"{name} motion_all")
    assert_rel_close(t_aggr, aggr, NETWORK, vm, f"{name} aggregate")
    assert_rel_close(t_out, out, NETWORK, vm, f"{name} head")
    # the temporal attention alone, fed the flax per-frame motion features
    agg = net.motion.aggregator(torch.as_tensor(np.asarray(motion_all)))
    F.assert_close(tcn.l2_normalize(agg), aggr, atol=TIGHT, what="TemporalAttn")


def test_skinmotion_matches_flax(fixture, flow_input):
    rng = np.random.default_rng(12)
    desc = rng.standard_normal((2, F.V_PAD, 40)).astype(np.float32)
    m = jrn.SkinMotion()
    p = F.flax_params(m, 7, jnp.asarray(desc), jnp.asarray(flow_input), fixture["jm"])
    with F.jax_fused_kernels():
        _, _, logits = m.apply({"params": p}, jnp.asarray(desc), jnp.asarray(flow_input),
                               fixture["jm"])
    net = F.bridged(trn.SkinMotion, W.flax_to_state_dict(p))
    got = net(torch.as_tensor(desc), torch.as_tensor(flow_input), fixture["tm"])[2]
    assert_rel_close(got, logits, NETWORK, fixture["vm"], "SkinMotion logits")
    np.testing.assert_array_equal(
        F.np_(trn.slice_skin_descriptor(torch.as_tensor(desc), 5, True, False)),
        np.asarray(jrn.slice_skin_descriptor(jnp.asarray(desc), 5, True, False)))


@pytest.fixture(scope="module")
def joint_set():
    rng = np.random.default_rng(13)
    J = 16
    joints = (rng.random((2, J, 3)) * [0.3, 0.8, 0.3] - [0.15, 0.1, 0.15]).astype(np.float32)
    jmask = np.zeros((2, J), bool)
    jmask[0, :11] = True
    jmask[1, :16] = True
    pairs = np.array(list(itertools.combinations(range(J), 2)), np.int32)
    pairs = np.broadcast_to(pairs, (2,) + pairs.shape).copy()
    dist = np.linalg.norm(np.take_along_axis(joints, pairs[..., :1].astype(np.int64), 1)
                          - np.take_along_axis(joints, pairs[..., 1:].astype(np.int64), 1),
                          axis=-1)
    attr = np.stack([dist, np.ones_like(dist)], -1).astype(np.float32)
    return joints, jmask, pairs, attr


def test_rootnet_matches_flax(fixture, joint_set):
    """The shape code (GCU layers: LAYER tolerance) moves every joint's logit
    alike, so the per-joint path is held tightly on the flax shape code."""
    joints, jmask, _, _ = joint_set
    m = jbn.RootNet()
    with F.jax_fused_kernels():
        p = F.flax_params(m, 8, fixture["jm"], jnp.asarray(joints), jnp.asarray(jmask))
        ref, state = m.apply({"params": p}, fixture["jm"], jnp.asarray(joints),
                             jnp.asarray(jmask), capture_intermediates=True,
                             mutable=["intermediates"])
    j_code = state["intermediates"]["shape_encoder"]["__call__"][0]
    net = F.bridged(tbn.RootNet, W.flax_to_state_dict(p))
    assert_rel_close(net.shape_encoder(fixture["tm"]), j_code, LAYER, what="RootNet shape code")
    net.shape_encoder.forward = lambda mesh: torch.as_tensor(np.asarray(j_code))
    got = net(fixture["tm"], torch.as_tensor(joints), torch.as_tensor(jmask))
    F.assert_close(got, ref, atol=TIGHT, what="RootNet logits")


def test_bonenet_matches_flax(fixture, joint_set):
    joints, jmask, pairs, attr = joint_set
    m = jbn.BoneNet()
    args = (jnp.asarray(joints), jnp.asarray(jmask), jnp.asarray(pairs), jnp.asarray(attr))
    with F.jax_fused_kernels():
        p = F.flax_params(m, 9, fixture["jm"], *args)
        ref = m.apply({"params": p}, fixture["jm"], *args)
    net = F.bridged(tbn.BoneNet, W.flax_to_state_dict(p))
    got = net(fixture["tm"], torch.as_tensor(joints), torch.as_tensor(jmask),
              torch.as_tensor(pairs).long(), torch.as_tensor(attr))
    assert_rel_close(got, ref, NETWORK, what="BoneNet logits")
    # the joint-set code alone has no edge layer: fp32 on both sides
    jcode = jbn.JointSetEncoder().apply({"params": p["joint_encoder"]}, *args[:2])
    F.assert_close(net.joint_encoder(torch.as_tensor(joints), torch.as_tensor(jmask)),
                   jcode, atol=TIGHT, what="JointSetEncoder")
