"""The port's data-parallel RigStage (jointnet) and BoneStage steps against
the JAX package's one-device step on the global batch, on the CPU.

Each takes one step at data = 2 on 2 spawned ranks over gloo, from JAX's
seeded weights (carried across by morig_tpu_torch.weights) on batches both
sides build from the same numpy seeds.  The draws are JAX's, each rank
taking its rows of the global draw (test_torch_parallel.patched_rank): the
rig step's multi-positive infoNCE indices (pred_flow = gt_flow, so the
50/50 flow draw does not matter) and BoneNet's pair swap (dropout 0 on both
sides).  The JAX side runs its Pallas kernels in interpret mode.  The
tolerances are those of test_torch_rig_train.py (losses at NETWORK, every
gradient at STEP_GRAD, the whole vector at STEP_GRAD_TOTAL) and
test_torch_skel_train.py (the loss and the gradient norm at NETWORK; its
gradients are held module by module there).
"""
import dataclasses
import functools

import jax
import numpy as np
import optax
import pytest
import torch

from morig_tpu.core.config import DEFAULT_CONFIG as JDEFAULT
from morig_tpu.data import rig as jrig
from morig_tpu.data import skeleton_data as jskel
from morig_tpu.kernels import neighbors as jnb
from morig_tpu.losses.basic import bce_with_logits
from morig_tpu.nn import bonenet as jbn
from morig_tpu.train import stages as jstages
from morig_tpu_torch import weights as W
from morig_tpu_torch.parallel import sharding, steps
from morig_tpu_torch.train import stages

import torch_port_fixtures as F
from test_torch_parallel import CFG, T_KEY, patched_rank
from torch_port_fixtures import NETWORK, STEP_GRAD, STEP_GRAD_TOTAL, assert_rel_close

NUM_SAMPLE = 64
RIG_DATA = dict(n_lat=7, n_lon=6, num_points=128, num_keyframes=T_KEY)
RIG = functools.partial(steps.rig_batch, num_models=4, pad_verts=128, degree=12,
                        gt_pred_flow=True, **RIG_DATA)
SKEL_DATA = dict(num_models=2, max_joints=8, num_points=64, n_lat=9, n_lon=8)
JCFG = dataclasses.replace(JDEFAULT, model=dataclasses.replace(JDEFAULT.model,
                                                              num_keyframes=T_KEY))


def _jax_rig():
    """JAX's rig jointnet step (key 11) on 4 capsules, its weights and the
    indices its embedding loss drew, one (ids, pos, neg) per keyframe and
    the aggregate."""
    ds = jrig.capsule_rig_dataset(4, **RIG_DATA)
    jb = jrig.RigDataset(ds.models, pad_verts=128, tpl_max_degree=12,
                         geo_max_degree=12).batch([0, 1, 2, 3])
    jb = dataclasses.replace(jb, pred_flow=jb.gt_flow)
    jstage = jstages.RigStage(JCFG, "jointnet", num_embed_sample=NUM_SAMPLE)
    key = jax.random.key(11)
    with F.jax_training_kernels():
        params = F.flax_params(jstage.model, 71, jb.gt_flow, jb.mesh, True)

        def loss_fn(p):
            return jstage._losses(key, jstage.model.apply({"params": p}, jb.gt_flow, jb.mesh,
                                                          True), jb)

        (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    draws = [tuple(torch.as_tensor(d) for d in F.jax_multi_pos_draws(
        k, jb.gt_skin, jb.mesh.vert_mask, NUM_SAMPLE)) for k in jax.random.split(key, T_KEY + 1)]
    return params, metrics, grads, draws


def _jax_bone():
    """JAX's BoneStage step (dropout 0, its pair swap from key 21's first
    split) on the two-capsule skeleton sample, its weights and the swap."""
    jb = jskel.capsule_skel_dataset(**SKEL_DATA)
    model = jbn.BoneNet(dropout=0.0)
    k_perm, k_drop = jax.random.split(jax.random.key(21))
    args = (jb.mesh, jb.joints, jb.joints_mask, jb.pairs, jb.pair_attr)
    jnb.set_topk_mode("exact")
    try:
        with F.jax_training_kernels():
            params = F.flax_params(model, 83, *args)

            def loss_fn(p):
                logits = model.apply({"params": p}, *args, True, True, k_perm,
                                     rngs={"dropout": k_drop})
                loss = bce_with_logits(logits[..., 0], jb.pair_label, jb.pair_mask)
                return loss, dict(total_loss=loss)

            (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        jnb.set_topk_mode("auto")
    swap = torch.as_tensor(np.array(jax.random.bernoulli(k_perm, 0.5,
                                                           jb.pairs.shape[:2] + (1,))))
    return params, metrics, grads, swap


def _port(name, factory, batch, params, patch, attrs=()):
    """Ranks 0 and 1's records of the port's data = 2 step from JAX's
    weights, the draws replaced as `patch` says."""
    case = steps.StepCase(name, factory, batch, generator_seed=0, model_attrs=attrs,
                          weights=steps.state_bytes(W.flax_to_state_dict(params)))
    return sharding.spawn(functools.partial(patched_rank, **patch), 2, "gloo", ["cpu"],
                          args=(2, 1, [case]), threads=1)


@pytest.fixture(scope="module")
def rig_pair():
    params, metrics, grads, draws = _jax_rig()
    ranks = _port("rig", functools.partial(stages.RigStage, CFG, "jointnet",
                                           num_embed_sample=NUM_SAMPLE),
                  RIG, params, dict(draws=draws))
    return dict(jmetrics=metrics, jgrads=W.flax_to_state_dict(grads), port=ranks[0][0],
                other=ranks[1][0]["metrics"])


@pytest.fixture(scope="module")
def bone_pair():
    params, metrics, grads, swap = _jax_bone()
    ranks = _port("bone", stages.BoneStage, functools.partial(steps.skel_batch, **SKEL_DATA),
                  params, dict(swap=swap), attrs=(("dropout", 0.0),))
    return dict(jmetrics=metrics, jgrads=grads, port=ranks[0][0], other=ranks[1][0]["metrics"],
                swap=swap)


def test_dp_rig_step_losses_match_jax(rig_pair):
    """The data = 2 rig step's losses (summed over the ranks, the same on
    both) at NETWORK against JAX's on the global batch."""
    metrics = rig_pair["port"]["metrics"]
    assert set(rig_pair["jmetrics"]) | {"grad_norm"} == set(metrics)
    assert rig_pair["other"] == metrics
    for k, v in rig_pair["jmetrics"].items():
        assert abs(metrics[k] - float(v)) <= NETWORK[0] * abs(float(v)), (k, metrics[k], v)


def test_dp_rig_step_grads_match_jax(rig_pair):
    """Every gradient before the clip (summed over the data group) at
    STEP_GRAD and the whole vector at STEP_GRAD_TOTAL against JAX's."""
    grads, ref = rig_pair["port"]["grads"], rig_pair["jgrads"]
    assert set(grads) == set(ref)
    for n, g in grads.items():
        assert_rel_close(g, ref[n], STEP_GRAD, what=n)
    flat = np.concatenate([F.np_(grads[n]).ravel() for n in grads])
    flat_ref = np.concatenate([np.asarray(ref[n]).ravel() for n in grads])
    assert np.linalg.norm(flat - flat_ref) <= STEP_GRAD_TOTAL * np.linalg.norm(flat_ref)


def test_dp_bone_step_matches_jax(bone_pair):
    """The data = 2 bone step (each rank its rows of JAX's pair swap): the
    loss and the gradient norm (over the data group's summed gradients) at
    NETWORK against JAX's loss and optax's global norm of its gradients;
    the swap draws both outcomes."""
    metrics = bone_pair["port"]["metrics"]
    assert bone_pair["other"] == metrics
    ref = float(bone_pair["jmetrics"]["total_loss"])
    assert abs(metrics["total_loss"] - ref) <= NETWORK[0] * abs(ref)
    jnorm = float(optax.global_norm(bone_pair["jgrads"]))
    assert abs(metrics["grad_norm"] - jnorm) <= NETWORK[0] * jnorm, (metrics["grad_norm"], jnorm)
    assert 0 < int(bone_pair["swap"].sum()) < bone_pair["swap"].numel()
