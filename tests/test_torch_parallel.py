"""Data- and tensor-parallel training of the port (morig_tpu_torch/parallel/)
against its one-device step, on the CPU: the counterpart of
tests/test_parallel.py.

The sharded steps run on 2 or 4 ranks spawned on the CPU and joined over
gloo; each holds the loss and every gradient before the optimizer (summed
over the data group, a sharded layer's slices gathered) against the
one-device step on the global batch in this process.  The weights are
`weights.randomize_`'s (heads included): with the fresh zero heads most
gradients of a first step are zero.  Tolerances:

  * LOSS_RTOL: the losses are sums of the ranks' shares; measured 0.
  * DP_L2: each gradient's and the whole vector's relative L2 error at
    data = 2, where only the order of fp32 sums changes (measured <=
    1.6e-6, the extractor's vismask head).
  * Gradients below 1e-5 of the largest (zero by the loss's form) are
    held relative to that bound (`steps.compare`).
  * K6_L2_TOL: with the wide layers split over the model group, a split
    layer's input gradient is the sum of the ranks' partial products.
    That fp32 difference reaches the edge layers upstream, whose backward
    (K6's plain version here) rounds ds, dh and dx to bf16, so a few
    elements land one bf16 ulp apart.  Each gradient and the whole vector
    are held at the relative L2 bound of the one-device K6 tests
    (test_torch_cuda.py; measured <= 7.1e-3 per gradient, a LayerNorm
    scale of the mesh encoder's second edge layer, and 1.0e-3 whole).
  * The "batch"-mode step runs at the fresh init of the JAX package's
    test_dp_matches_single_device_batchnorm: with random weights its
    statistics, summed in another order, move K2's voting selections
    across near ties (measured: loss 5.5e-4, whole gradient 0.32, running
    statistics 7.1e-5 relative).
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

from morig_tpu_torch.core.config import DEFAULT_CONFIG
from morig_tpu_torch.kernels.gather_fused import reverse_table
from morig_tpu_torch.losses import nce as tnce
from morig_tpu_torch.nn import bonenet as tbn
from morig_tpu_torch.parallel import current
from morig_tpu_torch.parallel import sharding, steps
from morig_tpu_torch.parallel.mesh import DeviceMesh
from morig_tpu_torch.train import stages

# the ranks and the test workers share the machine's cores (see
# torch_port_fixtures)
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
DP_L2 = 1e-4
K6_L2_TOL = 1e-2

T_KEY = 2
CFG = dataclasses.replace(DEFAULT_CONFIG, model=dataclasses.replace(
    DEFAULT_CONFIG.model, num_keyframes=T_KEY))
# the JAX dry run's batch (tests/test_parallel.py), and small rig and
# skeleton batches of 4 and 2 samples
POSE = functools.partial(steps.pose_batch, num_models=4, num_frames=4, num_points=64, n_lat=7,
                         n_lon=6)
RIG = functools.partial(steps.rig_batch, num_models=4, n_lat=7, n_lon=6, num_points=128,
                        num_keyframes=T_KEY)
SKEL = functools.partial(steps.skel_batch, num_models=2, max_joints=8, num_points=64, n_lat=9,
                         n_lon=8)
C = functools.partial(steps.StepCase, randomize=7)
CASES = {c.name: c for c in [
    C("deform", stages.DeformPoseStage, POSE),
    C("deform_extractor", functools.partial(stages.DeformPoseStage, train_extractor=True), POSE),
    C("corr", functools.partial(steps.corr_stage, True), POSE),
    steps.StepCase("deform_batch_norm", stages.DeformPoseStage, POSE, norm="batch"),
    C("rig_jointnet", functools.partial(stages.RigStage, CFG, "jointnet", num_embed_sample=64),
      RIG),
    C("bone", stages.BoneStage, SKEL),
]}
DP_CASES = list(CASES)


def patched_rank(rank, device, data, model, cases, swap=None, draws=None):
    """`steps.rank_cases` with the draws replaced by given global ones, of
    which each rank takes its rows: BoneNet's pair swap (`swap` (B, P, 1)
    bool) and the multi-positive infoNCE's indices (`draws`, a list of
    (ids, pos_ids, neg_ids) used in turn)."""
    if swap is not None:
        tbn.pair_swap = lambda generator, B, P, dev: current().rows(swap).to(dev)
    if draws is not None:
        replay = itertools.cycle(draws)

        def replayed(generator, feature, gt_skin, vert_mask, num_sample):
            mesh = current()
            return tnce.multi_pos_info_nce_drawn(feature, gt_skin, vert_mask,
                                                 *(mesh.rows(d) for d in next(replay)))

        stages.multi_pos_info_nce = replayed
    return steps.rank_cases(rank, device, data, model, cases)


def mesh_rank(rank, device, shapes):
    """Each mesh of `shapes` on this rank: its shape, indices and the
    global ranks of its two groups."""
    import torch.distributed as dist

    out = []
    for data, model in shapes:
        m = sharding.make_device_mesh(data, model)
        out.append((m.shape, m.data_index, m.model_index,
                    dist.get_process_group_ranks(m.data_group),
                    dist.get_process_group_ranks(m.model_group)))
    return out


# ---------------------------------------------------------------------------
# the one-device references and the sharded runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_device():
    return {name: steps.run_case(case, "cpu") for name, case in CASES.items()}


@pytest.fixture(scope="module")
def dp2():
    ranks = sharding.spawn(steps.rank_cases, 2, "gloo", ["cpu"],
                           args=(2, 1, [CASES[n] for n in DP_CASES]), threads=1)
    return {"ranks": ranks, **dict(zip(DP_CASES, ranks[0]))}


def _hold(got: dict, ref: dict, per: float, total: float, what: str) -> dict:
    """Losses at LOSS_RTOL, the same parameters with gradients, each
    gradient within `per` and the whole vector (and its norm) within
    `total` relative L2."""
    cmp = steps.compare(got, ref)
    for k, v in ref["metrics"].items():
        rel = total if k == "grad_norm" else LOSS_RTOL
        assert got["metrics"][k] == pytest.approx(v, rel=rel, abs=1e-12), (what, k)
    worst = max(cmp["per"], key=cmp["per"].get)
    assert cmp["per"][worst] <= per, (what, worst, cmp["per"][worst])
    assert cmp["total"] <= total, (what, cmp["total"])
    return cmp


# ---------------------------------------------------------------------------
# the mesh, the layers tensor parallelism splits, shard_batch, shard_state
# ---------------------------------------------------------------------------

def test_mesh_shapes():
    """make_device_mesh over 4 ranks: the shapes, row-major indices (data
    index rank // model) and the groups of the JAX package's mesh."""
    shapes = [(4, 1), (2, 2), (1, 4)]
    ranks = sharding.spawn(mesh_rank, 4, "gloo", ["cpu"], args=(shapes,))
    for r, per_rank in enumerate(ranks):
        for (data, model), (shape, d, k, dg, mg) in zip(shapes, per_rank):
            assert shape == {"data": data, "model": model}
            assert (d, k) == divmod(r, model)
            assert dg == [i * model + k for i in range(data)]
            assert mg == [d * model + j for j in range(model)]


def _jax_tp_picks(flax_model, *args):
    """The port's names of the parameters that the JAX package's
    `tp_param_spec` shards at model = 2, from the flax model's parameter
    shapes."""
    import types

    import jax

    from morig_tpu.parallel.sharding import tp_param_spec
    from morig_tpu_torch import weights as W

    shapes = jax.eval_shape(lambda k: flax_model.init(k, *args), jax.random.key(0))["params"]
    mesh = types.SimpleNamespace(shape={"model": 2})
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, float(
            tp_param_spec(path, leaf, mesh) != jax.sharding.PartitionSpec()), np.float32),
        shapes)
    return {n for n, t in W.flax_to_state_dict(marked).items() if bool((t == 1).all())}


DEFORM_TP = ["corr_extractor.mesh_enc.vtx_gcu_4.mlp.dense_0",
             "corr_extractor.mesh_enc.vtx_mlp_glb.dense_0",
             "corr_extractor.mesh_enc.vtx_mlp.mlp.dense_0",
             "corr_extractor.pts_enc.sa4.nn.dense_2",
             "completing.gcu_3.mlp.dense_0", "completing.mlp_glb.dense_0",
             "completing.mlp_transform.mlp.dense_0"]


@pytest.mark.parametrize("net", ["deform", "jointnet", "skin", "bone", "root"])
def test_tp_layers_are_the_jax_picks(net):
    """tp_layers shards exactly the Dense layers whose flax `kernel`
    `tp_param_spec` shards at model = 2 (output >= 512 and even); the edge
    layers' tables (`dense_1_kernel`, ...) and their `lin_self`/`lin_nbr`
    (at most 256 wide) stay whole, so K1 and K6 always get whole weights.
    The JAX rule also places the 512-wide LayerNorm biases after those
    layers on the model axis (storage only); the port keeps them whole,
    the LayerNorm sees whole channels after the gather."""
    from morig_tpu.data import pose as jpose
    from morig_tpu.data import rig as jrig
    from morig_tpu.data import skeleton_data as jskel
    from morig_tpu.nn import bonenet as jbn
    from morig_tpu.nn import deformnet as jdn
    from morig_tpu.nn import rignet as jrn
    from morig_tpu_torch.nn import bonenet as tbn_
    from morig_tpu_torch.nn import deformnet as tdn
    from morig_tpu_torch.nn import rignet as trn

    m = CFG.model
    if net == "deform":
        jb = jpose.capsule_pose_dataset(num_models=2, num_frames=4, num_points=64, n_lat=7,
                                        n_lon=6).batch([0, 1], 0, 2)
        jmodel, args, tmodel = jdn.DeformNet(), (jb.mesh, jb.points, True), tdn.DeformNet()
    elif net in ("jointnet", "skin"):
        jb = jrig.capsule_rig_dataset(2, n_lat=7, n_lon=6, num_points=128,
                                      num_keyframes=T_KEY).batch([0, 1])
        if net == "jointnet":
            jmodel = jrn.JointNetMotion(num_keyframes=T_KEY)
            args, tmodel = (jb.gt_flow, jb.mesh, True), trn.JointNetMotion(
                m.num_keyframes, m.motion_dim, m.aggr_method)
        else:
            jmodel = jrn.SkinMotion(num_keyframes=T_KEY)
            args = (jb.skin_input, jb.gt_flow, jb.mesh, True)
            tmodel = trn.SkinMotion(m.nearest_bone, m.use_Dg, m.use_Lf, m.num_keyframes,
                                    m.motion_dim)
    else:
        jb = jskel.capsule_skel_dataset(num_models=2, max_joints=8, num_points=64, n_lat=9,
                                        n_lon=8)
        if net == "bone":
            jmodel, tmodel = jbn.BoneNet(), tbn_.BoneNet()
            args = (jb.mesh, jb.joints, jb.joints_mask, jb.pairs, jb.pair_attr)
        else:
            jmodel, tmodel = jbn.RootNet(), tbn_.RootNet()
            args = (jb.mesh, jb.joints, jb.joints_mask)
    picks = _jax_tp_picks(jmodel, *args)
    layers = sharding.tp_layers(tmodel, 2)
    assert {n + ".weight" for n in layers} == {n for n in picks if n.endswith(".weight")}
    dense_biases = {n + ".bias" for n in layers}
    assert all(n in dense_biases or ".ln_" in n for n in picks if n.endswith(".bias")), picks
    assert not any("dense_1_kernel" in n or "lin_self" in n or "lin_nbr" in n for n in picks)
    if net == "deform":
        assert sorted(layers) == sorted(DEFORM_TP)
    assert sharding.tp_layers(tmodel, 1) == []


def _mesh(data, index):
    return DeviceMesh(data, 1, index, 0, None, None)


def test_shard_batch_splits_by_field():
    """Each data index gets B / data consecutive rows of every tensor field
    (nested batches too) and keeps `edge_tile`; a shard's MeshBatch builds
    its own reverse tables from its own tables even where the whole batch
    has built (and cached) its; a batch that does not split raises, and so
    does a field whose axis 0 is not the batch."""
    batch = POSE("cpu")
    batch = dataclasses.replace(batch, mesh=dataclasses.replace(batch.mesh, edge_tile=128))
    whole_rev = batch.mesh.tpl_rev
    for i in range(2):
        shard = sharding.shard_batch(batch, _mesh(2, i))
        assert shard.mesh.edge_tile == 128
        rows = slice(2 * i, 2 * i + 2)
        for name in ("verts", "vert_mask", "tpl_nbr", "tpl_mask", "geo_nbr", "geo_mask"):
            assert torch.equal(getattr(shard.mesh, name), getattr(batch.mesh, name)[rows])
        assert torch.equal(shard.points.pts, batch.points.pts[rows])
        assert torch.equal(shard.corr.p2v, batch.corr.p2v[rows])
        assert torch.equal(shard.gt_flow, batch.gt_flow[rows])
        rev = shard.mesh.tpl_rev
        ref = reverse_table(shard.mesh.tpl_nbr, shard.mesh.tpl_nbr.shape[1], shard.mesh.tpl_mask)
        assert rev is not whole_rev and all(torch.equal(a, b) for a, b in zip(rev, ref))
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_batch(batch, _mesh(3, 0))
    bad = dataclasses.replace(batch, vismask=batch.vismask[0])
    with pytest.raises(ValueError, match="vismask"):
        sharding.shard_batch(bad, _mesh(2, 0))
    skel = SKEL("cpu")
    shard = sharding.shard_batch(skel, _mesh(2, 1))
    assert torch.equal(shard.root_idx, skel.root_idx[1:]) and shard.pairs.shape[0] == 1


def test_shard_state_refuses_to_reinit_a_stepped_optimizer():
    """reinit_opt=True on a state past step 0 raises before any collective
    (the JAX guard), naming the step."""
    state = stages.DeformPoseStage().init_state(0, device="cpu")
    state.step = 3
    with pytest.raises(ValueError, match="step=3"):
        sharding.shard_state(state, _mesh(2, 0), tensor_parallel=False, reinit_opt=True)


def test_nccl_refuses_fewer_cards_than_ranks():
    """NCCL with fewer distinct cards than ranks raises at once and names
    gloo; nothing switches backend on its own."""
    with pytest.raises(ValueError, match="one distinct card per rank"):
        sharding.spawn(mesh_rank, 2, "nccl", ["cuda:0"], args=([(2, 1)],))
    with pytest.raises(ValueError, match="one distinct card per rank"):
        sharding.spawn(mesh_rank, 2, "nccl", ["cpu"], args=([(2, 1)],))


# ---------------------------------------------------------------------------
# sharded steps against the one-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DP_CASES)
def test_dp_step_matches_one_device(name, one_device, dp2):
    """A data = 2 step (the draws made at the global batch, the losses and
    gradients summed over the data group) equals the one-device step on the
    global batch: losses, every gradient, the running statistics; both
    ranks report the same losses."""
    got, ref = dp2[name], one_device[name]
    _hold(got, ref, DP_L2, DP_L2, name)
    assert set(got["buffers"]) == set(ref["buffers"])
    for n, b in ref["buffers"].items():
        assert steps.rel_l2(got["buffers"][n], b) <= DP_L2, n
    other = dp2["ranks"][1][DP_CASES.index(name)]["metrics"]
    assert other == got["metrics"]


def test_dp_batch_norm_running_statistics(one_device, dp2):
    """"batch" norm mode at data = 2: the masked moments are summed over the
    data group, so GCNDeform's running statistics after the step equal the
    one-device step's (tests/test_parallel.py's counterpart); the frozen
    extractor's stay at their initial values on both."""
    got, ref = dp2["deform_batch_norm"]["buffers"], one_device["deform_batch_norm"]["buffers"]
    moved = [n for n in ref if n.startswith("completing.") and n.endswith("running_mean")]
    assert sum(float(ref[n].abs().max()) > 0 for n in moved) > len(moved) // 2
    for n, b in ref.items():
        assert steps.rel_l2(got[n], b) <= DP_L2, n
        if n.startswith("corr_extractor.") and n.endswith("running_mean"):
            assert float(b.abs().max()) == 0.0 and float(got[n].abs().max()) == 0.0, n
