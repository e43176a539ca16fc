"""predict_rig_batch in the "batch" norm mode against the JAX DAG in that
mode, from the reference's PyTorch state dicts.

The six networks' reference-layout modules (full width, T=5, filled from
seeds with their BatchNorm statistics) are mapped by the JAX importer for
the JAX side and by the port's loader (`RigPredictor.from_reference`) for
the port.  The JAX networks' variables also go through the JAX package's
`save_checkpoint` and the port's `load_flax_checkpoint` +
`RigPredictor.from_flax_params(params, batch_stats)`, which must give the
same state dicts as the loader, bit for bit.

The three device programs and the host tail are then held as
tests/test_torch_slice.py holds them in "layer" mode, with its helpers and
tolerances (its `_apply` given the batch statistics): program 1's flow on
the flax CorrNet outputs at NETWORK, the clustering given the flax shifted
points exactly, program 2's root logits within 5e-3 and pair logits at
NETWORK on the JAX joints, the host NMS and MST given the JAX clusters and
logits exactly, program 3's skin logits at NETWORK and pruned weights
within 1e-2.  A whole predict_rig_batch call gives valid rigs and runs no
edge kernel, nor K1's plain version.
"""
import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.core import batch as JB
from morig_tpu.eval import torch_import as jti
from morig_tpu.nn import bonenet as jbn
from morig_tpu.nn import deformnet as jdn
from morig_tpu.nn import rignet as jrn
from morig_tpu.train import checkpoint as jckpt
from morig_tpu.train import stages as jstages
from morig_tpu.train import trainer as jtr
from morig_tpu_torch.core import batch as TB
from morig_tpu_torch.kernels import edge_fused as tef
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.pipelines import rig_predict as trp
from morig_tpu_torch.train import checkpoint as tckpt

import test_torch_slice as S
import torch_port_fixtures as F
from torch_port_fixtures import NETWORK, assert_rel_close
from test_parity_torch import (_BoneNetSkeleton, _JointNetOracle, _RootNetSkeleton,
                               _SkinMotionOracle)
from test_torch_import import DeformSkeleton
from torch_oracle import randomize_bn_stats

T, MAX_JOINTS = F.T, S.MAX_JOINTS

# name: (reference-layout module, JAX importer, flax network)
REFERENCE = {
    "deform": (DeformSkeleton, jti.import_deformnet, jdn.DeformNet),
    "joint": (lambda: _JointNetOracle(T=T, head="jointnet", chn_output=3), jti.import_jointnet,
              jrn.JointNetMotion),
    "mask": (lambda: _JointNetOracle(T=T, head="masknet", chn_output=1), jti.import_masknet,
             jrn.MaskNetMotion),
    "root": (_RootNetSkeleton, jti.import_rootnet, jbn.RootNet),
    "bone": (_BoneNetSkeleton, jti.import_bonenet, jbn.BoneNet),
    "skin": (lambda: _SkinMotionOracle(T=T, K=S.K), jti.import_skinmotion, jrn.SkinMotion),
}


def _batch_apply(d, name, *args, **kw):
    return d["nets"][name].apply({"params": d["params"][name], "batch_stats": d["stats"][name]},
                                 *args, **kw)


@pytest.fixture(scope="module")
def dag(tmp_path_factory):
    """The fixture of test_torch_slice.py in "batch" mode, from reference
    state dicts; test_torch_slice's `_apply` passes the batch statistics
    while this module's tests run."""
    with F.norm_mode("batch"), pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_apply", _batch_apply)
        entries, frames = F.capsule_inputs(2)
        jm, tm = F.meshes(entries)
        pts = np.concatenate(frames, 0)
        sds, nets, params, stats = {}, {}, {}, {}
        for seed, (name, (make, importer, jnet)) in enumerate(REFERENCE.items()):
            torch.manual_seed(60 + seed)
            ref = make()
            randomize_bn_stats(ref, torch.Generator().manual_seed(60 + seed))
            sds[name] = ref.state_dict()
            params[name], stats[name] = importer(jti.state_dict_to_numpy(sds[name]))
            nets[name] = jnet()
        pred = trp.RigPredictor.from_reference(sds, device="cpu")
        yield dict(entries=entries, frames=frames, jm=jm, tm=tm,
                   jm_bt=JB.stack_meshes([e for e in entries for _ in range(T)]),
                   jp=JB.PointBatch(jnp.asarray(pts), jnp.ones(pts.shape[:2], bool)),
                   tp=TB.PointBatch(torch.as_tensor(pts),
                                    torch.ones(pts.shape[:2], dtype=torch.bool)),
                   vm=np.asarray(jm.vert_mask), nets=nets, params=params, stats=stats,
                   pred=pred, tmp=tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def jax_dag(dag):
    """test_torch_slice's JAX DAG stages (programs 1 and 2 jitted, the host
    NMS between them) on the batch-mode networks."""
    with F.jax_fused_kernels():
        embeds, flow, shifted, attn_p, clusters = S._jit_program(S.jax_flow_joints, dag)
    joints_list = S.jax_host_joints(dag, clusters)
    joints_p = np.zeros((2, MAX_JOINTS, 3), np.float32)
    jmask = np.zeros((2, MAX_JOINTS), bool)
    for i, j in enumerate(joints_list):
        joints_p[i, :len(j)] = j
        jmask[i, :len(j)] = True
    with F.jax_fused_kernels():
        logits = np.asarray(S._jit_program(S.jax_skelnets, dag, jnp.asarray(joints_p),
                                           jnp.asarray(jmask)))
    return dict(embeds=embeds, flow=flow, shifted=shifted, attn_p=attn_p, clusters=clusters,
                nms_joints=joints_list, joints_list=joints_list, joints_p=joints_p, jmask=jmask,
                logits=logits)


def test_flax_checkpoints_load_with_their_statistics(dag):
    """Each network's variables written by the JAX package's save_checkpoint
    in "batch" mode load through load_flax_checkpoint with their
    batch_stats, and from_flax_params builds the loader's networks bit for
    bit."""
    params, stats = {}, {}
    for name in trp.NETS:
        tx = jstages.CorrPoseStage().make_tx()
        state = jtr.TrainState(step=jnp.asarray(3, jnp.int32), params=dag["params"][name],
                               batch_stats=flax.core.freeze(dag["stats"][name]),
                               opt_state=tx.init(dag["params"][name]), tx=tx,
                               apply_fn=dag["nets"][name].apply)
        got = tckpt.load_flax_checkpoint(jckpt.save_checkpoint(state, str(dag["tmp"] / name)))
        assert got["step"] == 3 and got["batch_stats"]
        params[name], stats[name] = got["params"], got["batch_stats"]
    pred = trp.RigPredictor.from_flax_params(params, stats, device="cpu")
    ref = dag["pred"].state_dict()
    got = pred.state_dict()
    assert set(got) == set(ref) and any(k.endswith("running_var") for k in got)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_flow_joints_program_batch_mode(dag, jax_dag):
    """Program 1 as test_torch_slice holds it: the mesh embedding at
    NETWORK, then the flow on the flax CorrNet outputs at NETWORK, the
    cluster outputs finite."""
    pred, tm = dag["pred"], dag["tm"]
    vtx_f, pts_f, vis_logits = (torch.as_tensor(np.asarray(x)) for x in jax_dag["embeds"])
    corr = pred.deform.corr_extractor
    assert_rel_close(corr.mesh_enc(tm), vtx_f, NETWORK, dag["vm"], "mesh embedding")
    with pytest.MonkeyPatch.context() as mp:
        for mod, val in ((corr.mesh_enc, vtx_f), (corr.pts_enc, pts_f),
                         (corr.lin_vismask, vis_logits)):
            mp.setattr(mod, "forward", lambda *_, v=val: v)
        flow, clusters = pred.flow_joints(tm.repeat_interleave(T), dag["tp"], tm, T)
    assert_rel_close(flow, jax_dag["flow"], NETWORK, dag["vm"], "flow")
    for got, ref in zip(clusters, jax_dag["clusters"]):
        assert got.shape == ref.shape and np.isfinite(F.np_(got).astype(np.float64)).all()


def test_cluster_stage_and_host_tail_batch_mode(dag, jax_dag):
    """The clustering on the flax shifted points and attention, and the host
    NMS and MST on the JAX clusters and logits, exactly."""
    S._check_clusters(S._port_clusters(dag, jax_dag), jax_dag["clusters"])
    S._check_host_tail(dag, jax_dag, False)


def test_skelnets_and_skin_programs_batch_mode(dag, jax_dag):
    """Programs 2 and 3 on the JAX DAG's joints, skeletons and flow."""
    frac, _ = S._check_skelnets(dag, jax_dag)
    np.testing.assert_array_equal(frac, 1.0)
    S._check_skin(dag, jax_dag, jax_dag["flow"])


def test_predict_rig_batch_batch_mode(dag):
    """A whole predict_rig_batch call: valid rigs, skin rows summing to 1,
    no edge kernel and no K1 plain version."""
    before = (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_windowed.launches,
              tgcu.plain_edge.launches)
    rigs = dag["pred"].predict_rig_batch(dag["entries"], dag["frames"], max_joints=MAX_JOINTS)
    assert before == (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_windowed.launches,
                      tgcu.plain_edge.launches)
    assert len(rigs) == 2
    for rig, e in zip(rigs, dag["entries"]):
        assert np.isfinite(rig.pos).all() and len(rig.pos) >= 1
        assert rig.skins.shape == (int(e["vert_mask"].sum()), len(rig.pos))
        if (rig.parents >= 0).any():
            np.testing.assert_allclose(rig.skins.sum(1), 1.0, atol=1e-3)
