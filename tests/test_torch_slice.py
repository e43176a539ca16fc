"""The port's three device programs and its host tail against the JAX DAG.

RigPredictor.flow_joints / skelnets / skin_full are held against the JAX
computations of morig_tpu/pipelines/rig_predict.py `_flow_joints_program`,
`_skelnets_program` and `_skin_full_program`, written out below from their
source without the f16/bf16 fetch casts, on identical inputs and bridged
weights, without voxels and with them (a 32^3 grid of the capsule and its
surface geodesics: voxel containment in the clustering, inside-fractions
as pair attributes, volumetric-geodesic skin distances).  The host tail
(NMS + flip + joint cap, Prim MST with and without the outside-bone cost)
is held exactly against the JAX DAG's host lines given the JAX cluster
outputs and logits.

The JAX side runs its Pallas kernels in interpret mode, at the port's
precision.  Tolerances: outputs behind GCU edge layers are held at the
NETWORK tolerance of torch_port_fixtures (mean |err| <= 2% of mean |ref|,
max <= 5% of max |ref|; the reasons and measured errors are stated there);
where a discrete step (the kNN voting, the visibility threshold, the
mean-shift modes) sits below that noise, the JAX intermediate is handed to
the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.core import batch as JB
from morig_tpu.core.config import DEFAULT_CONFIG
from morig_tpu.data import synthetic as jsyn
from morig_tpu.geometry import skeleton as sk
from morig_tpu.geometry import voxel as jvox
from morig_tpu.geometry.bones import point_to_segment_dist
from morig_tpu.geometry.clustering import nms_flip_host, select_and_cluster
from morig_tpu.geometry.geodesic import vertex_bone_geodesic_device
from morig_tpu.geometry.skinning import post_filter_skin, prune_and_normalize
from morig_tpu.nn import bonenet as jbn
from morig_tpu.nn import deformnet as jdn
from morig_tpu.nn import rignet as jrn
from morig_tpu_torch import weights as W
from morig_tpu_torch.core import batch as TB
from morig_tpu_torch.core import config as tcfg
from morig_tpu_torch.data import synthetic as tsyn
from morig_tpu_torch.geometry import skeleton as tsk
from morig_tpu_torch.geometry import clustering as tcl
from morig_tpu_torch.geometry import geodesic as tgeo
from morig_tpu_torch.geometry import voxel as tvox
from morig_tpu_torch.nn import bonenet as tbn
from morig_tpu_torch.nn import deformnet as tdn
from morig_tpu_torch.nn import rignet as trn
from morig_tpu_torch.pipelines import rig_predict as trp

import torch_port_fixtures as F
from torch_port_fixtures import NETWORK, TIGHT, assert_rel_close

T = F.T
MAX_JOINTS = 24
JC, SP = DEFAULT_CONFIG.joints, DEFAULT_CONFIG.skin_post
K = DEFAULT_CONFIG.model.nearest_bone


@pytest.fixture(scope="module")
def dag():
    entries, frames = F.capsule_inputs(2)
    Bn = len(entries)
    jm, tm = F.meshes(entries)
    jm_bt = JB.stack_meshes([e for e in entries for _ in range(T)])
    pts = np.concatenate(frames, 0)
    jp = JB.PointBatch(jnp.asarray(pts), jnp.ones(pts.shape[:2], bool))
    tp = TB.PointBatch(torch.as_tensor(pts), torch.ones(pts.shape[:2], dtype=torch.bool))
    flow0 = jnp.zeros((Bn, F.V_PAD, 3 * T))
    joints0 = jnp.zeros((Bn, MAX_JOINTS, 3))
    jmask0 = jnp.ones((Bn, MAX_JOINTS), bool)
    pairs0 = jnp.asarray(np.broadcast_to(trp.pair_table(MAX_JOINTS), (Bn, 276, 2)), jnp.int32)
    models = {
        "deform": (jdn.DeformNet(), tdn.DeformNet, W.flax_to_state_dict,
                   (jm, JB.PointBatch(jp.pts[:Bn], jp.pts_mask[:Bn]), False, None)),
        "joint": (jrn.JointNetMotion(), trn.JointNetMotion, W.flax_to_state_dict, (flow0, jm)),
        "mask": (jrn.MaskNetMotion(), trn.MaskNetMotion, W.flax_to_state_dict, (flow0, jm)),
        "root": (jbn.RootNet(), tbn.RootNet, W.flax_to_state_dict, (jm, joints0, jmask0)),
        "bone": (jbn.BoneNet(), tbn.BoneNet, W.flax_to_state_dict,
                 (jm, joints0, jmask0, pairs0, jnp.zeros((Bn, 276, 2)))),
        "skin": (jrn.SkinMotion(), trn.SkinMotion, W.flax_to_state_dict,
                 (jnp.zeros((Bn, F.V_PAD, 8 * K)), flow0, jm)),
    }
    jax_nets, params, port = {}, {}, {}
    for seed, (name, (m, tcls, bridge, args)) in enumerate(models.items()):
        jax_nets[name] = m
        params[name] = F.flax_params(m, 20 + seed, *args)
        port[name] = F.bridged(tcls, bridge(params[name]))
    pred = trp.RigPredictor(port["deform"], port["joint"], port["mask"], port["root"],
                            port["bone"], port["skin"])
    return dict(entries=entries, frames=frames, jm=jm, tm=tm, jm_bt=jm_bt, jp=jp, tp=tp,
                vm=np.asarray(jm.vert_mask), nets=jax_nets, params=params, pred=pred)


@pytest.fixture(scope="module")
def vox():
    """The capsule's 32^3 grid and surface geodesics (padded with 1e30), as the
    port's device triple and (B,V,V) bf16, the JAX triple and (B,V,V) bf16,
    and the host arrays predict_rig_batch takes."""
    cap = tsyn.make_capsule_rig(7, 6)
    grid = tvox.voxelize_mesh(cap.verts, cap.faces, dims=32)
    sg = tgeo.surface_geodesic(cap.verts, cap.faces, num_samples=500)
    sgp = np.full((2, F.V_PAD, F.V_PAD), 1e30, np.float32)
    sgp[:, :len(sg), :len(sg)] = sg
    jg = jvox.vox_to_device(jvox.Voxels(grid.data, grid.translate, grid.scale, grid.dims))
    return dict(port=tvox.vox_to_device([grid] * 2, "cpu"),
                port_sg=torch.as_tensor(sgp).to(torch.bfloat16),
                jax=tuple(jnp.stack([x, x]) for x in jg), jax_sg=jnp.asarray(sgp, jnp.bfloat16),
                voxes=[grid] * 2, surf_geos=[sg] * 2)


def _apply(d, name, *args, **kw):
    return d["nets"][name].apply({"params": d["params"][name]}, *args, **kw)


def _jit_program(fn, d, *args):
    """Run `fn(d, *args)` as one jitted program, as the JAX DAG does, with the
    weights and meshes as arguments."""
    keys = ("params", "jm", "jm_bt", "jp")

    def program(arrays, *a):
        return fn({**d, **dict(zip(keys, arrays))}, *a)

    return jax.jit(program)(tuple(d[k] for k in keys), *args)


# ---------------------------------------------------------------------------
# the JAX programs, pre-cast (morig_tpu/pipelines/rig_predict.py:238-264,
# :314-338, :359-421 with has_vox=False, geodesic=False)
# ---------------------------------------------------------------------------

def jax_flow_joints(d):
    jm, Bn = d["jm"], len(d["entries"])
    vtx_f_b = _apply(d, "deform", jm, None, False, None, mesh_only=True)
    (flow_bt, _, pts_f, _, _), state = _apply(
        d, "deform", d["jm_bt"], d["jp"], False, None, vtx_f=jnp.repeat(vtx_f_b, T, axis=0),
        capture_intermediates=lambda mdl, _: mdl.name == "lin_vismask",
        mutable=["intermediates"])
    vis_logits = state["intermediates"]["corr_extractor"]["lin_vismask"]["__call__"][0]
    V = flow_bt.shape[1]
    flow = jnp.transpose(jnp.reshape(flow_bt, (Bn, T, V, 3)), (0, 2, 1, 3)).reshape(Bn, V, 3 * T)
    _, _, shift = _apply(d, "joint", flow, jm)
    _, _, attn = _apply(d, "mask", flow, jm)
    shifted = jm.verts + jnp.tanh(shift)
    attn_p = jax.nn.sigmoid(attn[..., 0])
    clusters = select_and_cluster(
        shifted, attn_p, jm.vert_mask, None, None, None, quantile=JC.bandwidth_quantile,
        num_iter=JC.meanshift_max_iter, attn_threshold=JC.attn_threshold, symmetrize=True,
        has_vox=False, sample_rows=JC.bandwidth_sample_rows)
    return (vtx_f_b, pts_f, vis_logits), flow, shifted, attn_p, clusters


def jax_skelnets(d, joints, jmask, vox=None):
    pt = jnp.asarray(trp.pair_table(MAX_JOINTS), jnp.int32)
    Bn = joints.shape[0]
    a, b = joints[:, pt[:, 0]], joints[:, pt[:, 1]]
    dist = jnp.linalg.norm(a - b, axis=-1)
    if vox is not None:
        frac = jax.vmap(jvox.segment_inside_fraction)(a, b, *vox)
    else:
        frac = jnp.ones_like(dist)
    attr = jnp.stack([dist, frac], axis=-1)
    root_logits = _apply(d, "root", d["jm"], joints, jmask)
    pair_logits = _apply(d, "bone", d["jm"], joints, jmask,
                         jnp.broadcast_to(pt[None], (Bn,) + pt.shape), attr)
    return jnp.concatenate([root_logits[..., 0], pair_logits[..., 0], frac], axis=1)


def jax_skin_full(d, bones_packed, flow, surf_geo=None, vox=None):
    mesh = d["jm"]
    bones_p, isleaf_p = bones_packed[..., :6], bones_packed[..., 6]
    bone_mask = bones_packed[..., 7] > 0.5
    Bmax = bones_p.shape[1]

    def desc_one(verts, bones, isleaf, bmask, sg=None, g=None, tr=None, sc=None):
        Vn = verts.shape[0]
        if sg is not None:
            dd = vertex_bone_geodesic_device(
                verts, bones, bmask, sg, g, tr, sc, num_anchors=SP.geo_anchors,
                los_samples=SP.geo_los_samples, num_candidates=SP.geo_candidates)
        else:
            dd, _ = point_to_segment_dist(verts, bones)
            dd = jnp.where(bmask[None, :], dd, 1e30)
        neg, nn = jax.lax.top_k(-dd, K)
        dk = -neg
        ok = jnp.take_along_axis(jnp.broadcast_to(bmask[None, :], dd.shape), nn, axis=1)
        nn = jnp.where(ok, nn, nn[:, :1])
        dk = jnp.where(ok, dk, dk[:, :1])
        desc = jnp.concatenate([bones[nn], (1.0 / (dk + 1e-10))[..., None],
                                isleaf[nn].astype(jnp.float32)[..., None]],
                               axis=-1).reshape(Vn, K * 8)
        return desc, nn, ok.astype(jnp.float32)

    geo = () if surf_geo is None else (surf_geo, *vox)
    desc, nn, lmask = jax.vmap(desc_one)(mesh.verts, bones_p, isleaf_p, bone_mask, *geo)
    _, _, logits = _apply(d, "skin", desc, flow, mesh)
    probs = jax.nn.softmax(logits, axis=-1) * lmask
    full = jax.vmap(lambda p, n: jnp.zeros((p.shape[0], Bmax), jnp.float32).at[
        jnp.arange(p.shape[0])[:, None], n].add(p))(probs, nn)
    smoothed = jax.vmap(lambda f, nbr, msk: post_filter_skin(
        f, nbr, msk, num_ring=SP.post_filter_rings))(full, mesh.tpl_nbr, mesh.tpl_mask)
    pruned = jax.vmap(lambda f: prune_and_normalize(f, SP.prune_ratio_rig))(smoothed)
    return pruned, desc, logits, smoothed


def jax_host_joints(d, clusters):
    """The JAX DAG's host NMS lines (rig_predict.py:545-558)."""
    moved, bws, counts, attn2, sel2 = (np.asarray(c, np.float32) for c in clusters)
    out = []
    for i, (j, dens) in enumerate(nms_flip_host(
            moved, bws, counts, attn2, sel2 > 0.5, density_threshold=JC.density_threshold,
            attn_nms_threshold=JC.attn_nms_threshold, symmetrize=True, return_density=True)):
        if len(j) == 0:
            e = d["entries"][i]
            j = e["verts"][e["vert_mask"]].mean(0, keepdims=True)
        elif len(j) > MAX_JOINTS:
            j = j[np.argsort(-np.asarray(dens), kind="stable")[:MAX_JOINTS]]
        out.append(j)
    return out


def jax_host_mst(joints_list, logits, outside_cost=False):
    """The JAX DAG's host MST lines (rig_predict.py:577-600)."""
    max_pairs = MAX_JOINTS * (MAX_JOINTS - 1) // 2
    pairs = trp.pair_table(MAX_JOINTS)
    parents = []
    for i, joints in enumerate(joints_list):
        J = len(joints)
        root_id = int(np.argmax(logits[i, :MAX_JOINTS][:J]))
        ok = (pairs[:, 0] < J) & (pairs[:, 1] < J)
        pr = pairs[ok]
        prob = np.zeros((J, J))
        prob[pr[:, 0], pr[:, 1]] = 1.0 / (1.0 + np.exp(
            -logits[i, MAX_JOINTS:MAX_JOINTS + max_pairs][ok]))
        prob = prob + prob.T
        cost = -np.log(prob + 1e-10)
        if outside_cost:
            cost = sk.increase_cost_for_outside_bone(
                cost, joints, frac=logits[i, MAX_JOINTS + max_pairs:][ok])
        parents.append(sk.prim_mst(cost, root_id))
    return parents


@pytest.fixture(scope="module")
def jax_dag(dag):
    with F.jax_fused_kernels():
        embeds, flow, shifted, attn_p, clusters = _jit_program(jax_flow_joints, dag)
    joints_list = jax_host_joints(dag, clusters)
    joints_p = np.zeros((2, MAX_JOINTS, 3), np.float32)
    jmask = np.zeros((2, MAX_JOINTS), bool)
    for i, j in enumerate(joints_list):
        joints_p[i, :len(j)] = j
        jmask[i, :len(j)] = True
    with F.jax_fused_kernels():
        logits = np.asarray(_jit_program(jax_skelnets, dag, jnp.asarray(joints_p),
                                         jnp.asarray(jmask)))
    return dict(embeds=embeds, flow=flow, shifted=shifted, attn_p=attn_p, clusters=clusters,
                nms_joints=joints_list, joints_list=joints_list, joints_p=joints_p, jmask=jmask,
                logits=logits)


@pytest.fixture(scope="module")
def jax_vox(dag, jax_dag, vox):
    """The JAX DAG's stages with voxels, from the flax attention of `jax_dag`
    and its shifted points moved into the capsule: each vertex halfway to
    the axis, plus 1/20 of its flax shift (with random heads tanh(shift)
    moves most vertices out of the volume): clustering with containment and
    host NMS.  Skelnets with inside-fractions then run on the joints of
    `jax_dag`, which lie in and out of the volume (segments between joints
    inside the convex capsule never leave it)."""
    verts = dag["jm"].verts
    shifted = verts * jnp.asarray([0.5, 1.0, 0.5]) + 0.05 * (jax_dag["shifted"] - verts)
    clusters = select_and_cluster(
        shifted, jax_dag["attn_p"], dag["jm"].vert_mask, *vox["jax"],
        quantile=JC.bandwidth_quantile, num_iter=JC.meanshift_max_iter,
        attn_threshold=JC.attn_threshold, symmetrize=True, has_vox=True,
        sample_rows=JC.bandwidth_sample_rows)
    joints_p, jmask = jax_dag["joints_p"], jax_dag["jmask"]
    with F.jax_fused_kernels():
        logits = np.asarray(_jit_program(jax_skelnets, dag, jnp.asarray(joints_p),
                                         jnp.asarray(jmask), vox["jax"]))
    return dict(shifted=shifted, attn_p=jax_dag["attn_p"], clusters=clusters,
                nms_joints=jax_host_joints(dag, clusters), joints_list=jax_dag["joints_list"],
                joints_p=joints_p, jmask=jmask, logits=logits)


def test_flow_joints_program(dag, jax_dag):
    """Program 1 on identical meshes, clouds and weights.  The mesh embedding
    is held at the NETWORK tolerance.  Downstream of it the kNN voting, the 0.5
    visibility threshold and the similarity-weighted vote (whose sums come
    near 0 for some vertices with random weights) turn fp32- and bf16-level
    differences into different selections, so the program is then run on the
    flax mesh embedding, point embedding and vismask logits: the (B, V, 3T)
    flow at the NETWORK tolerance, every cluster output finite and of its
    shape."""
    pred, tm = dag["pred"], dag["tm"]
    vtx_f, pts_f, vis_logits = (torch.as_tensor(np.asarray(x)) for x in jax_dag["embeds"])
    corr = pred.deform.corr_extractor
    assert_rel_close(corr.mesh_enc(tm), vtx_f, NETWORK, dag["vm"], "mesh embedding")
    corr.mesh_enc.forward = lambda *_: vtx_f
    corr.pts_enc.forward = lambda *_: pts_f
    corr.lin_vismask.forward = lambda *_: vis_logits
    try:
        flow, clusters = pred.flow_joints(tm.repeat_interleave(T), dag["tp"], tm, T)
    finally:
        for mod in (corr.mesh_enc, corr.pts_enc, corr.lin_vismask):
            del mod.forward
    assert_rel_close(flow, jax_dag["flow"], NETWORK, dag["vm"], "flow")
    assert np.abs(F.np_(flow)[dag["vm"]]).mean() > 0.1      # random heads: not 0
    for got, ref in zip(clusters, jax_dag["clusters"]):
        assert got.shape == ref.shape and np.isfinite(F.np_(got).astype(np.float64)).all()


def _check_clusters(got, ref):
    moved, bw, counts, attn2, sel2 = (F.np_(g) for g in got)
    ref = [np.asarray(r) for r in ref]
    F.assert_close(bw, ref[1], atol=0, rtol=1e-5, what="bandwidth")
    F.assert_close(moved, ref[0], atol=TIGHT, what="moved")
    np.testing.assert_array_equal(counts, ref[2])
    F.assert_close(attn2, ref[3], atol=1e-6)
    np.testing.assert_array_equal(sel2, ref[4])
    assert sel2.any()
    return sel2


def _port_clusters(dag, jax_dag, vox=None):
    return tcl.select_and_cluster(
        torch.as_tensor(np.asarray(jax_dag["shifted"])),
        torch.as_tensor(np.asarray(jax_dag["attn_p"])), torch.as_tensor(dag["vm"]),
        JC.bandwidth_quantile, JC.meanshift_max_iter, JC.attn_threshold,
        JC.bandwidth_sample_rows, vox=vox)


def test_cluster_stage_given_jax_inputs(dag, jax_dag):
    """Program 1's clustering tail on the flax shifted points and attention:
    fp32 on both sides, so tight (counts and selection exact)."""
    _check_clusters(_port_clusters(dag, jax_dag), jax_dag["clusters"])


def test_cluster_stage_with_voxels_given_jax_inputs(dag, jax_vox, vox):
    """The same with voxel containment ANDed into the selection: exact
    selection, and it drops shifted points outside the volume."""
    sel2 = _check_clusters(_port_clusters(dag, jax_vox, vox["port"]), jax_vox["clusters"])
    assert sel2.sum() < F.np_(_port_clusters(dag, jax_vox)[4]).sum()


def _check_skelnets(dag, stages, vox=None):
    got = F.np_(dag["pred"].skelnets(torch.as_tensor(stages["joints_p"]),
                                     torch.as_tensor(stages["jmask"]), dag["tm"], vox))
    ref = stages["logits"]
    assert got.shape == ref.shape == (2, MAX_JOINTS + 2 * 276)
    jmask = stages["jmask"]
    F.assert_close(got[:, :MAX_JOINTS][jmask], ref[:, :MAX_JOINTS][jmask], atol=5e-3,
                   what="root logits")
    assert_rel_close(got[:, MAX_JOINTS:MAX_JOINTS + 276], ref[:, MAX_JOINTS:MAX_JOINTS + 276],
                     NETWORK, what="pair logits")
    return got[:, MAX_JOINTS + 276:], ref[:, MAX_JOINTS + 276:]


def test_skelnets_program(dag, jax_dag):
    """Program 2 on the JAX DAG's joints: pair logits at the NETWORK
    tolerance; root logits within 5e-3 of the flax ones (measured 4.3e-4:
    the shape code differs at the LAYER level and moves every root logit
    of a mesh alike)."""
    frac, _ = _check_skelnets(dag, jax_dag)
    np.testing.assert_array_equal(frac, 1.0)


def test_skelnets_program_with_voxels(dag, jax_vox, vox):
    """The same with the segments' voxel inside-fractions as the second pair
    attribute: the fractions exactly, the logits as above."""
    frac, ref = _check_skelnets(dag, jax_vox, vox["port"])
    np.testing.assert_array_equal(frac, ref)
    assert (frac < 1).any() and (frac > 0).any()


def _check_host_tail(dag, stages, outside_cost):
    clusters = [np.asarray(c) for c in stages["clusters"]]
    joints = trp.joints_from_clusters(clusters, dag["entries"], MAX_JOINTS,
                                      JC.density_threshold, JC.attn_nms_threshold)
    assert len(joints) == len(stages["nms_joints"])
    for got, ref in zip(joints, stages["nms_joints"]):
        np.testing.assert_array_equal(got, ref)
    joints = stages["joints_list"]
    skels = trp.skeletons_from_logits(joints, stages["logits"], MAX_JOINTS, outside_cost)
    for s, ref in zip(skels, jax_host_mst(joints, stages["logits"], outside_cost)):
        np.testing.assert_array_equal(s.parents, ref)


def test_host_tail_matches_jax(dag, jax_dag):
    """Given the JAX cluster outputs and logits, the port's host NMS/flip/cap
    returns the same joints and its Prim MST the same parents."""
    _check_host_tail(dag, jax_dag, False)


def test_host_tail_with_outside_bone_cost_matches_jax(dag, jax_vox):
    """The same on the voxel stages, the MST costs raised for pairs that
    leave the volume (which changes the skeleton here)."""
    _check_host_tail(dag, jax_vox, True)
    with_cost = trp.skeletons_from_logits(jax_vox["joints_list"], jax_vox["logits"],
                                          MAX_JOINTS, True)
    without = trp.skeletons_from_logits(jax_vox["joints_list"], jax_vox["logits"],
                                        MAX_JOINTS, False)
    assert any((a.parents != b.parents).any() for a, b in zip(with_cost, without))


# The pruning zeroes a smoothed weight below prune_ratio x its row's max, a
# step in the weight.  The logits' error e (their largest over the valid
# vertices; they are held at NETWORK first) moves a softmax probability by
# at most e / 2 (to first order: p_i (1 - p_i) times the spread of the
# logits' errors, at most 2 e), the one-ring smoothing averages those, so a
# smoothed weight and its row's max each move by at most e / 2 and a weight
# that lies within (1 + prune_ratio) e / 2 of the threshold may take the
# other side of it; those vertices, found from the JAX side's smoothed
# weights, are left out of the comparison of the pruned weights, and their
# count is bounded by PRUNE_NEAR_FRAC of the valid vertices (measured 19 of
# 76 on the JAX DAG's skeletons, 7 of 76 on the voxel stages' with
# geodesics, 0 of 76 in batch mode).
PRUNE_NEAR_FRAC = 0.3


def near_prune_threshold(ref_smoothed, logits, ref_logits, vm):
    """(B, V) bool: the vertices with a smoothed weight (the JAX side's,
    before pruning) within (1 + prune_ratio) e / 2 of prune_ratio x its row's
    max, e the largest error of the port's skin logits over the valid
    vertices `vm`."""
    e = np.abs(F.np_(logits).astype(np.float64) - np.asarray(ref_logits, np.float64))[vm].max()
    sm = np.asarray(ref_smoothed, np.float64)
    r = SP.prune_ratio_rig
    margin = np.abs(sm - r * sm.max(-1, keepdims=True)).min(-1)
    return vm & (margin <= (1 + r) * e / 2)


def _check_skin(dag, stages, flow, vox=None, monkeypatch=None):
    skels = trp.skeletons_from_logits(stages["joints_list"], stages["logits"], MAX_JOINTS,
                                      vox is not None)
    raw = [sk.get_bones(s) for s in skels]
    M = trp.bone_slots(max(len(r[0]) for r in raw), MAX_JOINTS)
    bp = np.zeros((2, M, 8), np.float32)
    for i, (bones, _, isleaf) in enumerate(raw):
        nb = min(len(bones), M)
        bp[i, :nb, :6], bp[i, :nb, 6], bp[i, :nb, 7] = bones[:nb], isleaf[:nb], 1.0
    geo = {} if vox is None else dict(surf_geo=vox["jax_sg"], vox=vox["jax"])
    with F.jax_fused_kernels():
        ref, desc, ref_logits, ref_sm = jax_skin_full(dag, jnp.asarray(bp), flow, **geo)
    if vox is not None:
        # the port's geodesics agree to fp32 rounding; bones equidistant from
        # a vertex (a leaf bone and its parent bone share an end) then tie,
        # and a last-bit difference reorders them in one vertex's
        # descriptor, so the port's program runs on the JAX geodesics
        kw = dict(num_anchors=SP.geo_anchors, los_samples=SP.geo_los_samples,
                  num_candidates=SP.geo_candidates)
        bmask = bp[..., 7] > 0.5
        ref_d = np.asarray(jax.vmap(lambda *a: vertex_bone_geodesic_device(*a, **kw))(
            dag["jm"].verts, bp[..., :6], bmask, vox["jax_sg"], *vox["jax"]))
        got_d = tgeo.vertex_bone_geodesic_device(
            dag["tm"].verts, torch.as_tensor(bp[..., :6]), torch.as_tensor(bmask),
            vox["port_sg"], *vox["port"], **kw)
        F.assert_close(got_d, ref_d, atol=1e-5, rtol=1e-5, what="geodesics")
        monkeypatch.setattr(trp, "vertex_bone_geodesic_device",
                            lambda *a, **k: torch.as_tensor(ref_d))
    t_flow = torch.as_tensor(np.asarray(flow))
    port_geo = () if vox is None else (vox["port"], vox["port_sg"])
    got = F.np_(dag["pred"].skin_full(torch.as_tensor(bp), t_flow, dag["tm"], *port_geo))
    ref = np.asarray(ref)
    vm = dag["vm"]
    if monkeypatch is not None:
        monkeypatch.undo()
    logits = dag["pred"].skin(torch.as_tensor(np.asarray(desc)), t_flow, dag["tm"])[2]
    assert_rel_close(logits, ref_logits, NETWORK, vm, "skin logits")
    near = near_prune_threshold(ref_sm, logits, ref_logits, vm)
    assert near.sum() <= PRUNE_NEAR_FRAC * vm.sum(), (near.sum(), vm.sum())
    err = np.abs(got - ref)[vm & ~near]
    assert err.max() <= 1e-2, err.max()
    np.testing.assert_allclose(got[vm].sum(-1), 1.0, atol=1e-5)


def test_skin_full_program(dag, jax_dag):
    """Program 3 on the JAX DAG's skeletons and flow: the skin logits at the
    NETWORK tolerance, the smoothed, pruned weights within 1e-2 (measured
    2.2e-3) away from the 0.35 x row-max pruning threshold, where the
    logits' error can flip a weight to 0 or back (`near_prune_threshold`;
    a LayerNorm mean's summation order alone flips one weight here, an
    error of 0.26 in its vertex's weights), and rows that sum to 1."""
    _check_skin(dag, jax_dag, jax_dag["flow"])


def test_skin_full_program_with_geodesics(dag, jax_dag, jax_vox, vox, monkeypatch):
    """The same on the voxel stages' skeletons (14 and 23 bones: the padded
    bone axis is 32, so the candidate branch runs) with volumetric-geodesic
    bone distances, which agree with the JAX package's to 1e-5; the
    descriptors, scatter, smoothing and pruning are then held on the JAX
    geodesics and skin logits."""
    _check_skin(dag, jax_vox, jax_dag["flow"], vox, monkeypatch)


def test_predict_rig_batch_with_voxels_and_geodesics(dag, vox):
    """The whole DAG on the CPU with voxels, surface geodesics, the windowed
    edge dispatch and a device cache: valid rigs, twice from one cache; a
    cache of another batch raises."""
    entries, frames = dag["entries"], dag["frames"]
    cache: dict = {}
    for _ in range(2):
        rigs = dag["pred"].predict_rig_batch(entries, frames, voxes=vox["voxes"],
                                             surf_geos=vox["surf_geos"], max_joints=MAX_JOINTS,
                                             device_cache=cache, edge_tile=32)
        assert cache["mesh_b"].edge_tile == 32 and cache["mesh_bt"].edge_tile == 32
        assert set(cache) >= {"vox", "surf_geo"} and cache["surf_geo"].dtype == torch.bfloat16
        assert len(rigs) == 2
        for rig, e in zip(rigs, entries):
            assert np.isfinite(rig.pos).all() and len(rig.pos) >= 1
            assert rig.skins.shape == (int(e["vert_mask"].sum()), len(rig.pos))
            if (rig.parents >= 0).any():
                np.testing.assert_allclose(rig.skins.sum(1), 1.0, atol=1e-3)
    with pytest.raises(ValueError, match="another mesh batch"):
        dag["pred"].predict_rig_batch(entries[:1], frames[:1], device_cache=cache, edge_tile=32)


# ---------------------------------------------------------------------------
# the host modules the port carries as copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_lat,n_lon", [(0, 7, 6), (3, 17, 16)])
def test_capsule_fixture_matches_jax_package(seed, n_lat, n_lon):
    """The port's capsule generator gives the JAX package's arrays exactly."""
    ref = jsyn.make_capsule_sequence(num_frames=6, num_points=128, seed=seed,
                                     n_lat=n_lat, n_lon=n_lon)
    got = tsyn.make_capsule_sequence(num_frames=6, num_points=128, seed=seed,
                                     n_lat=n_lat, n_lon=n_lon)
    for key in ("vtx_traj", "pts_traj", "tpl_edges", "geo_edges"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ("verts", "faces", "joints", "parents", "skins"):
        np.testing.assert_array_equal(getattr(got["rig"], key), getattr(ref["rig"], key))


def test_config_matches_jax_package():
    """Every constant of the port's Config equals the JAX package's."""
    import dataclasses
    for group in dataclasses.fields(tcfg.DEFAULT_CONFIG):
        port, ref = getattr(tcfg.DEFAULT_CONFIG, group.name), getattr(DEFAULT_CONFIG, group.name)
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), (group.name, f.name)
    # the volumetric skin path's constants are among them
    assert {"geo_anchors", "geo_los_samples", "geo_candidates"} <= {
        f.name for f in dataclasses.fields(tcfg.SkinPostConfig)}
    # and the motion stages' constants
    assert {"num_interp", "num_keyframes", "motion_dim", "aggr_method", "use_Dg",
            "use_Lf"} <= {f.name for f in dataclasses.fields(tcfg.ModelConfig)}


def _branching_rig(rng, J=9):
    joints = rng.random((J, 3))
    parents = np.array([-1, 0, 1, 1, 0, 4, 4, 4, 2])[:J]
    return joints, parents


def test_skeleton_helpers_match_jax_package():
    """Prim MST, the outside-bone cost, bones with leaf bones,
    duplicate-joint assembly and its removal, on branching rigs and a
    single joint."""
    rng = np.random.default_rng(5)
    for J in (1, 5, 9):
        joints, parents = _branching_rig(rng, J)
        cost = rng.random((J, J)) + 0.1
        cost = cost + cost.T
        np.testing.assert_array_equal(tsk.prim_mst(cost, J // 2), sk.prim_mst(cost, J // 2))
        mid = joints.copy()
        mid[::2, 0] = 0.0                                    # middle-plane joints
        frac = rng.random(J * (J - 1) // 2 + 3)              # padded like the fetch
        np.testing.assert_array_equal(tsk.increase_cost_for_outside_bone(cost, mid, frac=frac),
                                      sk.increase_cost_for_outside_bone(cost, mid, frac=frac))
        got_rig, ref_rig = tsk.rig_from_parents(joints, parents), sk.rig_from_parents(joints, parents)
        for g, r in zip(tsk.get_bones(got_rig), sk.get_bones(ref_rig)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        attach = rng.random((30, len(sk.get_bones(ref_rig)[0])))
        got = tsk.remove_duplicate_joints(tsk.assemble_skel_skin(got_rig, attach))
        ref = sk.remove_duplicate_joints(sk.assemble_skel_skin(ref_rig, attach))
        assert got.names == ref.names
        for key in ("pos", "parents", "skins"):
            np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))
