"""The port's single-mesh rig API and its host helpers against the JAX package.

`RigPredictor.predict_flow` / `predict_shift_attn` / `predict_joints` /
`predict_skel` / `predict_skin` / `predict_rig`, `predict_skeleton`,
`extract_joints`, `build_skel_sample` and the copied host code (Rig
methods, the symmetric MST, skin descriptors) are held against
morig_tpu/pipelines/rig_predict.py's `RigPredictor` and its helpers on the
same inputs and weights; `load_flax_checkpoint` reads checkpoints the JAX
package's `save_checkpoint` writes.

Fixture: one capsule (n_lat=9, n_lon=8: V=74 padded to 128, degree-12
tables), T=5 keyframe clouds of P=128 points (128, not fewer: below it the
JAX kNN leaves its fused kernel for an fp32 XLA path the port does not
mirror), the six networks with seeded random parameters (heads included)
as real stage states of the JAX package (its stages' models and optimizers),
bridged to the port by `RigPredictor.from_flax_params`.  The JAX side runs
its Pallas kernels in interpret mode (`jax_fused_kernels`), at the port's
precision.

Where a discrete step sits below the networks' bf16 noise the JAX
intermediate is handed to the port, as in test_torch_slice: DeformNet's
kNN voting and visibility threshold (the port's flow is computed on the
JAX mesh embedding, point embedding and vismask logits), and the skin
pruning threshold (a weight of this fixture lies within 9e-4 of 0.35 x its
row max, while the smoothed weights differ by up to 2.0e-3).
"""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.core import batch as JB
from morig_tpu.data import skeleton_data as jsd
from morig_tpu.geometry import bones as jbones
from morig_tpu.geometry import clustering as jcl
from morig_tpu.geometry import skeleton as jsk
from morig_tpu.geometry import voxel as jvox
from morig_tpu.pipelines import rig_predict as jrp
from morig_tpu.pipelines import skeleton as jps
from morig_tpu.train import checkpoint as jckpt
from morig_tpu.train import stages as jst
from morig_tpu.train import trainer as jtr
from morig_tpu_torch import weights as W
from morig_tpu_torch.core import batch as TB
from morig_tpu_torch.data import creature as tcr
from morig_tpu_torch.data import skeleton_data as tsd
from morig_tpu_torch.data import synthetic as tsyn
from morig_tpu_torch.geometry import bones as tbones
from morig_tpu_torch.geometry import clustering as tcl
from morig_tpu_torch.geometry import skeleton as tsk
from morig_tpu_torch.geometry import voxel as tvox
from morig_tpu_torch.pipelines import rig_predict as trp
from morig_tpu_torch.pipelines import skeleton as tps
from morig_tpu_torch.train import checkpoint as tckpt

import torch_port_fixtures as F
from torch_port_fixtures import NETWORK, TIGHT, assert_rel_close

T, P, V_PAD = 5, 128, 128
K = 5
JC = jrp.DEFAULT_CONFIG.joints
# Joints of the whole DAG matched as sets: each port joint within SET_TOL of
# a JAX joint and back.  The port's flow (on the JAX embeddings) differs at
# the NETWORK level, JointNet's shifts by up to 0.05 (of ~0.56), and the
# mean-shift modes follow: measured 0.025 on joints ~1 from the origin.
SET_TOL = 0.06


def _stages():
    return dict(deform=jst.DeformPoseStage(), joint=jst.RigStage(arch="jointnet"),
                mask=jst.RigStage(arch="masknet"), root=jst.RootStage(), bone=jst.BoneStage(),
                skin=jst.SkinStage())


@pytest.fixture(scope="module")
def nets():
    """The capsule request, the JAX RigPredictor over stage states of seeded
    parameters and the port's, bridged from the same parameter trees."""
    entries, frames = tsyn.capsule_batch(1, T, P, V_PAD, 12, n_lat=9, n_lon=8)
    entry, pts = entries[0], frames[0]
    jm = JB.stack_meshes([entry])
    flow0, J0 = jnp.zeros((1, V_PAD, 3 * T)), 8
    joints0, jmask0 = jnp.zeros((1, J0, 3)), jnp.ones((1, J0), bool)
    n_pairs = J0 * (J0 - 1) // 2
    args = dict(
        deform=(jm, JB.PointBatch(jnp.asarray(pts[:1]), jnp.ones((1, P), bool)), False, None),
        joint=(flow0, jm), mask=(flow0, jm), root=(jm, joints0, jmask0),
        bone=(jm, joints0, jmask0, jnp.zeros((1, n_pairs, 2), jnp.int32),
              jnp.zeros((1, n_pairs, 2))),
        skin=(jnp.zeros((1, V_PAD, 8 * K)), flow0, jm))
    stages, states = _stages(), {}
    for seed, (name, stage) in enumerate(stages.items()):
        params = F.flax_params(stage.model, 40 + seed, *args[name])
        tx = stage.make_tx()
        states[name] = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=flax.core.freeze({}),
                                      opt_state=tx.init(params), tx=tx,
                                      apply_fn=stage.model.apply)
    jpred = jrp.RigPredictor(*[x for n in trp.NETS for x in (stages[n], states[n])])
    tpred = trp.RigPredictor.from_flax_params({n: states[n].params for n in trp.NETS},
                                              device="cpu")
    return dict(entry=entry, pts=pts, jm=jm, tm=TB.stack_meshes([entry], "cpu"),
                vm=np.asarray(entry["vert_mask"]), stages=stages, states=states,
                jpred=jpred, tpred=tpred)


@pytest.fixture(scope="module")
def jax_run(nets):
    """One JAX DeformNet forward over the T-repeated mesh (what
    `predict_flow` runs) with its mesh and point embeddings and vismask
    logits captured, then the JAX `predict_rig` from that flow, with its
    stage outputs."""
    entry, pts, jpred = nets["entry"], nets["pts"], nets["jpred"]
    model = nets["stages"]["deform"].model
    mesh_t = JB.stack_meshes([entry] * T)
    points = JB.PointBatch(jnp.asarray(pts), jnp.ones(pts.shape[:2], bool))
    with F.jax_fused_kernels():
        (flow, vtx_f, pts_f, _, _), state = jax.jit(lambda p, m, q: model.apply(
            {"params": p}, m, q, False, None,
            capture_intermediates=lambda mdl, _: mdl.name == "lin_vismask",
            mutable=["intermediates"]))(nets["states"]["deform"].params, mesh_t, points)
        vis_logits = state["intermediates"]["corr_extractor"]["lin_vismask"]["__call__"][0]
        flow = np.concatenate(list(np.asarray(flow)), axis=-1)      # (V, 3T), frame-major
        inter: dict = {}
        jpred.predict_flow = lambda *_: flow                        # the same forward
        try:
            rig = jpred.predict_rig(entry, pts, intermediates=inter)
        finally:
            del jpred.predict_flow
        joints = jpred.predict_joints(entry, flow, shift_attn=(inter["shifted"], inter["attn"]))
        skel = jpred.predict_skel(entry, joints)
        bones, _, isleaf = jsk.get_bones(skel)
        desc, _, _ = jbones.pack_skin_descriptors(
            np.asarray(jbones.point_to_segment_dist(jnp.asarray(entry["verts"]),
                                                   jnp.asarray(bones, jnp.float32))[0]),
            bones, isleaf, K)
        _, _, skin_logits = nets["stages"]["skin"].infer(
            nets["states"]["skin"], jnp.asarray(desc[None]), jnp.asarray(flow[None]), nets["jm"])
        skinned = jpred.predict_skin(entry, skel, flow)
    embeds = tuple(torch.as_tensor(np.asarray(x)) for x in (vtx_f, pts_f, vis_logits))
    return dict(flow=flow, embeds=embeds, shifted=inter["shifted"], attn=inter["attn"],
                joints=joints, skel=skel, desc=desc, skin_logits=np.asarray(skin_logits),
                skinned=skinned, rig=rig)


@pytest.fixture
def on_jax_embeddings(nets, jax_run):
    """The port's DeformNet with its mesh encoder, point encoder and vismask
    head returning the JAX ones (for the T-repeated mesh)."""
    corr = nets["tpred"].deform.corr_extractor
    mods = (corr.mesh_enc, corr.pts_enc, corr.lin_vismask)
    for mod, x in zip(mods, jax_run["embeds"]):
        mod.forward = lambda *_, _x=x: _x
    yield
    for mod in mods:
        del mod.forward


# ---------------------------------------------------------------------------
# the host copies
# ---------------------------------------------------------------------------

def _rigs(seed):
    """A creature skeleton (mirrored limbs) with a random skin, as JAX and
    port Rigs."""
    c = tcr.make_creature(seed, target_verts=300, res=20)
    skins = np.random.default_rng(seed).random((40, len(c.joints)))
    skins[skins < 0.6] = 0.0
    make = lambda mod: mod.Rig(names=list(c.names), pos=c.joints.astype(float),
                               parents=c.parents.astype(int), skins=skins)
    return make(tsk), make(jsk)


@pytest.mark.parametrize("seed", [0, 3])
def test_rig_methods_match_jax_package(seed, tmp_path):
    """Rig.offsets / adjacency, and save / load: the port writes the JAX
    package's file byte for byte and reads it back to the same rig."""
    got, ref = _rigs(seed)
    np.testing.assert_array_equal(got.offsets(), ref.offsets())
    np.testing.assert_array_equal(got.adjacency(), ref.adjacency())
    got.save(tmp_path / "port.txt")
    ref.save(tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    back, ref_back = tsk.Rig.load(tmp_path / "jax.txt"), jsk.Rig.load(tmp_path / "jax.txt")
    assert back.names == ref_back.names
    for key in ("pos", "parents", "skins"):
        np.testing.assert_array_equal(getattr(back, key), getattr(ref_back, key))


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_symmetric_mst_matches_jax_package(seed):
    """side_of, mirror_map and prim_mst_symmetry on creature joints (exact
    mirror pairs about x=0, a sided root that snaps to the middle) under
    random symmetric costs."""
    c = tcr.make_creature(seed, target_verts=300, res=20)
    joints = c.joints.astype(np.float64)
    rng = np.random.default_rng(seed)
    cost = rng.random((len(joints),) * 2) + 0.1
    cost = cost + cost.T
    np.testing.assert_array_equal(tsk.side_of(joints), jsk.side_of(joints))
    assert tsk.mirror_map(joints) == jsk.mirror_map(joints) != {}
    root = int(np.argmax(jsk.side_of(joints)))              # a right-hand joint
    got, ref = tsk.prim_mst_symmetry(cost, root, joints), jsk.prim_mst_symmetry(cost, root, joints)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] != root


@pytest.mark.parametrize("num_bones", [3, 5, 11])
def test_skin_descriptors_match_jax_package(num_bones):
    """pack_skin_descriptors (fewer bones than K included, with tied
    distances) and scatter_skin_full, exactly."""
    rng = np.random.default_rng(num_bones)
    dist = rng.random((50, num_bones)).astype(np.float32)
    dist[::7, 1] = dist[::7, 0]                              # ties
    bones = rng.random((num_bones, 6))
    isleaf = rng.random(num_bones) < 0.5
    got = tbones.pack_skin_descriptors(dist, bones, isleaf, K)
    ref = jbones.pack_skin_descriptors(dist, bones, isleaf, K)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    probs = rng.random((50, K)).astype(np.float32)
    np.testing.assert_array_equal(tbones.scatter_skin_full(probs, got[1], got[2], num_bones),
                                  jbones.scatter_skin_full(probs, ref[1], ref[2], num_bones))


@pytest.fixture(scope="module")
def capsule_vox():
    cap = tsyn.make_capsule_rig(9, 8)
    return tvox.voxelize_mesh(cap.verts, cap.faces, dims=32)


def _cloud(seed, n=300):
    """Shifted points clustered around a few centres, some off the capsule,
    and their raw attention."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform([-0.1, -0.05, -0.1], [0.1, 0.6, 0.1], (6, 3))
    pts = centres[rng.integers(0, 6, n)] + 0.02 * rng.standard_normal((n, 3))
    return pts.astype(np.float32), rng.random(n).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "voxels", "no_symmetry", "sampled_rows"])
def test_extract_joints_matches_jax(case, capsule_vox):
    """The single-mesh joint extraction on the same shifted points and
    attention: host filters, reflection, device bandwidth and mean-shift on
    the unpadded cloud, NMS and flip.  fp32 on both sides (the JAX
    bandwidth by its "auto" bisection): joints within TIGHT."""
    pts, attn = _cloud(len(case))
    kw = dict(bandwidth_quantile=JC.bandwidth_quantile, attn_keep_threshold=JC.attn_threshold,
              density_threshold=JC.density_threshold, attn_nms_threshold=JC.attn_nms_threshold,
              meanshift_iters=JC.meanshift_max_iter, symmetrize=case != "no_symmetry",
              bandwidth_sample_rows=128 if case == "sampled_rows" else 0)
    got_fn = ref_fn = None
    if case == "voxels":
        v = capsule_vox
        got_fn = lambda p: tvox.inside_check_np(p, v)
        ref_fn = lambda p: jvox.inside_check_np(p, jvox.Voxels(v.data, v.translate, v.scale,
                                                               v.dims))
        np.testing.assert_array_equal(got_fn(pts), ref_fn(pts))
        assert 0 < got_fn(pts).sum() < len(pts)
    got = tcl.extract_joints(pts, attn, inside_fn=got_fn, device="cpu", **kw)
    ref = jcl.extract_joints(pts, attn, inside_fn=ref_fn, **kw)
    assert got.shape == ref.shape and len(got) >= 2
    F.assert_close(got, ref, atol=TIGHT, what="joints")


def test_build_skel_sample_matches_jax(nets, capsule_vox):
    """Pairs, masks, [distance, inside fraction] attributes, labels and root
    of two meshes (one with a voxel grid, one without; GT rigs given) in a
    padded sample, exactly."""
    trig, jrig = _rigs(2)
    lift = np.array([0.0, 0.25, 0.0])                        # some segments leave the capsule
    joints = [(trig.pos[:9] + lift).astype(np.float32), (trig.pos[:6] + lift).astype(np.float32)]
    sub = lambda mod, rig, n: mod.Rig(names=rig.names[:n], pos=rig.pos[:n],
                                      parents=rig.parents[:n])
    v = capsule_vox
    got = tsd.build_skel_sample([nets["entry"]] * 2, joints,
                                rigs=[sub(tsk, trig, 9), sub(tsk, trig, 6)],
                                voxes=[v, None], max_joints=12, device="cpu")
    ref = jsd.build_skel_sample([nets["entry"]] * 2, joints,
                                rigs=[sub(jsk, jrig, 9), sub(jsk, jrig, 6)],
                                voxes=[jvox.Voxels(v.data, v.translate, v.scale, v.dims), None],
                                max_joints=12)
    for f in dataclasses.fields(ref):
        if f.name != "mesh":
            np.testing.assert_array_equal(F.np_(getattr(got, f.name)),
                                          np.asarray(getattr(ref, f.name)), err_msg=f.name)
    frac = F.np_(got.pair_attr)[0, :36, 1]
    assert (frac < 1).any() and (frac > 0).any()


@pytest.mark.parametrize("symmetric", [False, True])
def test_predict_skeleton_matches_jax(nets, jax_run, symmetric):
    """predict_skeleton on the JAX DAG's joints (mirror pairs from the flip)
    with the same RootNet and BoneNet weights: the same parents (the
    root logits agree to ~5e-4, the pair logits at NETWORK, and no MST
    choice of this fixture is that close)."""
    joints = jax_run["joints"]
    s = nets["stages"]
    got = tps.predict_skeleton(nets["entry"], joints, nets["tpred"].root, nets["tpred"].bone,
                               symmetric=symmetric)
    with F.jax_fused_kernels():
        ref = jps.predict_skeleton(nets["entry"], joints, nets["states"]["root"], s["root"],
                                   nets["states"]["bone"], s["bone"], symmetric=symmetric)
    np.testing.assert_array_equal(got.parents, ref.parents)
    np.testing.assert_array_equal(got.pos, ref.pos)
    if symmetric:
        assert tsk.mirror_map(joints)


# ---------------------------------------------------------------------------
# the single-mesh stages, each fed the JAX side's upstream output
# ---------------------------------------------------------------------------

def test_predict_flow_on_jax_embeddings(nets, jax_run, on_jax_embeddings):
    """predict_flow (DeformNet on the T-repeated mesh, the (V, 3T)
    frame-major layout) on the JAX embeddings: NETWORK (measured mean 2.2e-3,
    max 5.9e-3 relative)."""
    flow = nets["tpred"].predict_flow(nets["entry"], nets["pts"])
    assert flow.shape == (V_PAD, 3 * T)
    assert_rel_close(flow, jax_run["flow"], NETWORK, nets["vm"], "flow")


def test_predict_shift_attn_matches_jax(nets, jax_run):
    """JointNet shifts and MaskNet attention on the JAX flow, valid vertices
    only: the shift (shifted - verts) and the attention at NETWORK."""
    entry, vm = nets["entry"], nets["vm"]
    shifted, attn = nets["tpred"].predict_shift_attn(entry, jax_run["flow"])
    assert shifted.shape == (vm.sum(), 3) and attn.shape == (vm.sum(),)
    verts = entry["verts"][vm]
    assert_rel_close(shifted - verts, jax_run["shifted"] - verts, NETWORK, what="shift")
    assert_rel_close(attn, jax_run["attn"], NETWORK, what="attention")


def test_predict_joints_matches_jax(nets, jax_run):
    """The joint stage on the JAX shifted points and attention: TIGHT."""
    got = nets["tpred"].predict_joints(nets["entry"], jax_run["flow"],
                                       shift_attn=(jax_run["shifted"], jax_run["attn"]))
    assert got.shape == jax_run["joints"].shape and len(got) >= 4
    F.assert_close(got, jax_run["joints"], atol=TIGHT, what="joints")


def test_predict_skel_matches_jax(nets, jax_run):
    got = nets["tpred"].predict_skel(nets["entry"], jax_run["joints"])
    np.testing.assert_array_equal(got.parents, jax_run["skel"].parents)


def test_predict_skin_matches_jax(nets, jax_run, monkeypatch):
    """The skin stage on the JAX skeleton and flow.  SkinMotion's logits on
    the JAX descriptors at NETWORK (measured mean 2.7e-3, max 6.9e-3
    relative); then, on the JAX logits, the port's descriptors, scatter,
    smoothing, pruning and assembly give the JAX rig: names and parents
    exactly, skin weights within 1e-5."""
    tpred, entry = nets["tpred"], nets["entry"]
    logits = tpred.skin(torch.as_tensor(jax_run["desc"][None]),
                        torch.as_tensor(jax_run["flow"][None]), nets["tm"])[2]
    assert_rel_close(logits, jax_run["skin_logits"], NETWORK, nets["vm"][None], "skin logits")
    ref_logits = torch.as_tensor(jax_run["skin_logits"])
    monkeypatch.setattr(tpred.skin, "forward", lambda *_: (None, None, ref_logits))
    got, ref = tpred.predict_skin(entry, jax_run["skel"], jax_run["flow"]), jax_run["skinned"]
    assert got.names == ref.names
    np.testing.assert_array_equal(got.parents, ref.parents)
    F.assert_close(got.skins, ref.skins, atol=1e-5, what="skins")
    np.testing.assert_allclose(got.skins.sum(1), 1.0, atol=1e-5)


def test_predict_rig_matches_jax(nets, jax_run, on_jax_embeddings):
    """The whole single-mesh DAG on the JAX embeddings: as many joints as the
    JAX rig, matched as sets within SET_TOL, the intermediates returned, a
    skin row per valid vertex summing to 1, and stage timings."""
    inter, timings = {}, {}
    rig = nets["tpred"].predict_rig(nets["entry"], nets["pts"], intermediates=inter,
                                    timings=timings)
    ref = jax_run["rig"]
    assert len(rig.pos) == len(ref.pos) >= 4
    d = np.linalg.norm(rig.pos[:, None] - ref.pos[None], axis=-1)
    assert d.min(1).max() <= SET_TOL and d.min(0).max() <= SET_TOL, d.min(1)
    assert set(inter) == {"flow", "shifted", "attn"}
    assert set(timings) == {"flow", "shift_attn", "joints", "skel", "skin"}
    assert rig.skins.shape == (nets["vm"].sum(), len(rig.pos))
    np.testing.assert_allclose(rig.skins.sum(1), 1.0, atol=1e-5)


def test_predict_rig_degenerate_fallback(nets, monkeypatch):
    """No joint found: one joint at the centroid of the valid vertices, one
    leaf bone, every vertex skinned to it."""
    tpred, entry = nets["tpred"], nets["entry"]
    monkeypatch.setattr(tpred, "predict_joints", lambda *a, **k: np.zeros((0, 3), np.float32))
    rig = tpred.predict_rig(entry, nets["pts"])
    vm = nets["vm"]
    np.testing.assert_allclose(rig.pos, entry["verts"][vm].mean(0, keepdims=True), atol=1e-6)
    np.testing.assert_allclose(rig.skins, 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# flax checkpoints
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_flax_checkpoints_load_into_the_port(nets, tmp_path):
    """Each network's stage state written by the JAX package's
    save_checkpoint: step and every parameter leaf bit for bit, the Adam
    moments too, and all six networks built from the files with
    load_state_dict(strict=True)."""
    params = {}
    for name in trp.NETS:
        state = nets["states"][name].replace(step=jnp.asarray(7 + len(name), jnp.int32))
        path = jckpt.save_checkpoint(state, str(tmp_path / name))
        got = tckpt.load_flax_checkpoint(path)
        assert got["step"] == 7 + len(name) and got["batch_stats"] == {}
        ref = flax.serialization.to_state_dict(state.params)
        got_leaves, ref_leaves = dict(_leaves(got["params"])), dict(_leaves(ref))
        assert got_leaves.keys() == ref_leaves.keys()
        for k, v in ref_leaves.items():
            assert got_leaves[k].dtype == np.asarray(v).dtype
            assert np.array_equal(got_leaves[k], np.asarray(v)), k
        mu = flax.serialization.to_state_dict(state.opt_state)
        assert len(dict(_leaves(got["opt_state"]))) == len(dict(_leaves(mu)))
        params[name] = got["params"]
    pred = trp.RigPredictor.from_flax_params(params, device="cpu")
    for a, b in zip(pred.state_dict().values(), nets["tpred"].state_dict().values()):
        assert torch.equal(a, b)


def test_flax_checkpoint_chunked_and_bf16(tmp_path, monkeypatch):
    """Leaves above flax's MAX_CHUNK_SIZE (patched small) come back from
    their chunks; bfloat16 leaves come back as torch.bfloat16, bit for bit
    (also chunked); an unknown ext type raises."""
    rng = np.random.default_rng(0)
    kernel = rng.standard_normal((64, 48)).astype(np.float32)
    half = jnp.asarray(rng.standard_normal((40, 33)), jnp.bfloat16)
    state = dict(step=jnp.int32(5), params={"dense": {"kernel": kernel, "bias": half},
                                            "scale": np.float32(0.25)},
                 batch_stats={}, opt_state={"count": np.int64(3)})
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1024)
    data = flax.serialization.to_bytes(state)
    assert data.count(b"__msgpack_chunked_array__") == 2
    (tmp_path / "c.msgpack").write_bytes(data)
    got = tckpt.load_flax_checkpoint(str(tmp_path / "c.msgpack"))
    assert got["step"] == 5
    np.testing.assert_array_equal(got["params"]["dense"]["kernel"], kernel)
    bias = got["params"]["dense"]["bias"]
    assert bias.dtype == torch.bfloat16 and bias.shape == (40, 33)
    assert torch.equal(bias.view(torch.int16),
                       torch.from_numpy(np.asarray(half).view(np.int16)))
    assert got["params"]["scale"] == np.float32(0.25)
    sd = W.flax_to_state_dict(got["params"])
    assert torch.equal(sd["dense.weight"], torch.from_numpy(kernel.T))
    assert sd["dense.bias"].dtype == torch.float32
    (tmp_path / "bad.msgpack").write_bytes(b"\x81\xa4step\xd4\x02\x00")
    with pytest.raises(ValueError, match="ext type 2"):
        tckpt.load_flax_checkpoint(str(tmp_path / "bad.msgpack"))
