"""The port's data-parallel pose steps against the JAX package's one-device
step on the global batch, on the CPU.

DeformPoseStage (extractor frozen and trained) and CorrPoseStage (vismask
branch on) take one step at data = 2 on 2 spawned ranks over gloo, from
JAX's seeded weights (carried across by morig_tpu_torch.weights) on the
batch of 4 capsules both sides build from the same numpy seeds, FPS from
index 0 (JAX rng=None, the port's generator None).  The JAX side runs its
Pallas kernels in interpret mode (`jax_training_kernels`); JAX's own
test_parallel.py holds its sharded step to this one-device step.  The
tolerances are those of test_torch_deform_train.py and test_torch_train.py
between the port's one-device step and JAX (torch_port_fixtures states
them with the measured errors).
"""
import functools

import jax
import numpy as np
import pytest

from morig_tpu.data import pose as jpose
from morig_tpu.nn import corrnet as jcn
from morig_tpu.nn import deformnet as jdn
from morig_tpu.train import stages as jstages
from morig_tpu_torch import weights as W
from morig_tpu_torch.parallel import sharding, steps
from morig_tpu_torch.train import stages

import torch_port_fixtures as F
from torch_port_fixtures import (EXTRACTOR_GRAD_TOTAL, EXTRACTOR_GROUP_L2, GRAD, GRAD_TOTAL,
                                 NETWORK, STEP_GRAD, STEP_GRAD_TOTAL, assert_rel_close)

# test_torch_deform_train's capsules, four of them: V and P at 128 so the
# JAX kNN and gather run their Pallas kernels
DATA = dict(num_models=4, num_frames=4, num_points=128, n_lat=7, n_lon=6)
POSE = functools.partial(steps.pose_batch, degree=12, buckets=(128,), **DATA)


def _jax_batch():
    ds = jpose.capsule_pose_dataset(**DATA)
    ds = jpose.PoseDataset(ds.models, tpl_max_degree=12, geo_max_degree=12, buckets=(128,))
    return ds.batch(list(range(DATA["num_models"])), 0, 2)


def _jax_deform(jb, train_extractor: bool):
    """JAX's losses and gradients of one DeformPoseStage step (the
    extractor's left out where frozen, as optax.multi_transform's
    set_to_zero discards them) and its seeded weights."""
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
        (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trained)
    return params, metrics, grads


def _jax_corr(jb):
    jstage = jstages.CorrPoseStage()
    model = jcn.CorrNet()
    with F.jax_training_kernels():
        params = F.flax_params(model, 31, jb.mesh, jb.points, True, True)

        def loss_fn(p):
            outputs = model.apply({"params": p}, jb.mesh, jb.points, True, True, None)
            return jstage._losses(outputs, jb, True)

        (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, metrics, grads


@pytest.fixture(scope="module")
def steps_pair():
    """For each stage JAX's one-device step and rank 0's record of the
    port's data = 2 step (rank 1's metrics beside it)."""
    jb = _jax_batch()
    ref = {"deform": _jax_deform(jb, False), "deform_extractor": _jax_deform(jb, True),
           "corr": _jax_corr(jb)}
    factories = {"deform": stages.DeformPoseStage,
                 "deform_extractor": functools.partial(stages.DeformPoseStage,
                                                       train_extractor=True),
                 "corr": functools.partial(steps.corr_stage, True)}
    cases = [steps.StepCase(n, factories[n], POSE, generator_seed=None,
                            weights=steps.state_bytes(W.flax_to_state_dict(ref[n][0])))
             for n in ref]
    ranks = sharding.spawn(steps.rank_cases, 2, "gloo", ["cpu"], args=(2, 1, cases), threads=1)
    return {n: dict(jmetrics=ref[n][1], jgrads=W.flax_to_state_dict(ref[n][2]), port=ranks[0][i],
                    other=ranks[1][i]["metrics"])
            for i, n in enumerate(ref)}


def _rel_l2(got: dict, ref: dict, names) -> float:
    flat = np.concatenate([F.np_(got[n]).ravel() for n in names])
    flat_ref = np.concatenate([np.asarray(ref[n]).ravel() for n in names])
    return float(np.linalg.norm(flat - flat_ref) / np.linalg.norm(flat_ref))


@pytest.mark.parametrize("name", ["deform", "deform_extractor", "corr"])
def test_dp_step_losses_match_jax(name, steps_pair):
    """The data = 2 step's losses (summed over the ranks, the same on both)
    at NETWORK against JAX's on the global batch."""
    s = steps_pair[name]
    metrics = s["port"]["metrics"]
    assert set(s["jmetrics"]) | {"grad_norm"} == set(metrics) and s["other"] == metrics
    for k, v in s["jmetrics"].items():
        assert abs(metrics[k] - float(v)) <= NETWORK[0] * abs(float(v)), (k, metrics[k], v)


@pytest.mark.parametrize("name", ["deform", "deform_extractor", "corr"])
def test_dp_step_grads_match_jax(name, steps_pair):
    """Every gradient before the clip (summed over the data group) against
    JAX's: the deform steps at STEP_GRAD / STEP_GRAD_TOTAL (with the
    extractor trained PointNet++'s as a group at EXTRACTOR_GROUP_L2 and the
    whole vector at EXTRACTOR_GRAD_TOTAL), the corr step at GRAD /
    GRAD_TOTAL; the frozen extractor takes no gradient."""
    s = steps_pair[name]
    grads, ref = s["port"]["grads"], s["jgrads"]
    assert set(grads) == set(ref)
    per, total = (GRAD, GRAD_TOTAL) if name == "corr" else (STEP_GRAD, STEP_GRAD_TOTAL)
    held = dict(grads)
    if name == "deform":
        assert not any(n.startswith("corr_extractor.") for n in grads)
    if name == "deform_extractor":
        pts = [n for n in grads if n.startswith("corr_extractor.pts_enc.")]
        assert _rel_l2(grads, ref, pts) <= EXTRACTOR_GROUP_L2
        held = {n: g for n, g in grads.items() if n not in pts}
        total = EXTRACTOR_GRAD_TOTAL
    for n, g in held.items():
        assert_rel_close(g, ref[n], per, what=n)
    assert _rel_l2(grads, ref, list(grads)) <= total
