"""Tensor-parallel training of the port (morig_tpu_torch/parallel/) against
its one-device step, `gather_state`, and the multichip dry run, on the CPU:
the counterpart of tests/test_parallel.py's tp tests and dry run.  The
cases, the ranks' functions and the tolerances are test_torch_parallel's
(its docstring states them)."""
import numpy as np
import pytest
import torch

from morig_tpu_torch.parallel import sharding, steps
from morig_tpu_torch.parallel.dryrun import dryrun_multichip
from morig_tpu_torch.train import stages

from test_torch_parallel import CASES, DEFORM_TP, K6_L2_TOL, _hold

TP_CASES = ["deform", "deform_extractor"]


def gather_rank(rank, device):
    """A DeformPoseStage state sharded over a 2 x 2 mesh: its sharded
    layers' local shapes and `gather_state`'s whole state."""
    mesh = sharding.make_device_mesh(2, 2)
    state = stages.DeformPoseStage(train_extractor=True).init_state(0, device=device)
    state = sharding.shard_state(state, mesh, tensor_parallel=True, reinit_opt=True)
    shapes = {n: tuple(p.shape) for n, p in state.model.named_parameters()
              if n in sharding.sharded_names(state.model)}
    return shapes, sharding.gather_state(state, mesh)



@pytest.fixture(scope="module")
def one_device():
    return {name: steps.run_case(CASES[name], "cpu") for name in TP_CASES}


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=["model2", "data2_model2"])
def tp(request):
    data, model = request.param
    ranks = sharding.spawn(steps.rank_cases, data * model, "gloo", ["cpu"],
                           args=(data, model, [CASES[n] for n in TP_CASES]), threads=1)
    return {"ranks": ranks, **dict(zip(TP_CASES, ranks[0]))}


def test_gather_state_rebuilds_the_whole_state():
    """shard_state on a 2 x 2 mesh keeps half of each picked layer's output
    rows, and gather_state gives back the whole state, equal to the
    unsharded one bit for bit."""
    ranks = sharding.spawn(gather_rank, 4, "gloo", ["cpu"], threads=1)
    whole = stages.DeformPoseStage(train_extractor=True).init_state(0, device="cpu")
    ref = whole.model.state_dict()
    for shapes, gathered in ranks:
        assert sorted(shapes) == sorted(f"{n}.{p}" for n in DEFORM_TP for p in ("weight", "bias"))
        for n, s in shapes.items():
            assert s[0] * 2 == ref[n].shape[0] and s[1:] == ref[n].shape[1:]
        assert set(gathered) == set(ref)
        for n, t in ref.items():
            assert torch.equal(gathered[n], t), n


@pytest.mark.parametrize("name", TP_CASES)
def test_tp_step_matches_one_device(name, one_device, tp):
    """model = 2 and data = 2 x model = 2 DeformPoseStage steps (the wide
    Dense layers split over the model group), extractor frozen and
    trained, equal the one-device step: losses at LOSS_RTOL, each gradient
    and the whole vector at K6_L2_TOL (test_torch_parallel's docstring
    states why); every rank reports the same losses."""
    _hold(tp[name], one_device[name], K6_L2_TOL, K6_L2_TOL, name)
    for r in tp["ranks"][1:]:
        assert r[TP_CASES.index(name)]["metrics"] == tp[name]["metrics"]


def test_dryrun_multichip_on_the_cpu(capsys):
    """dryrun_multichip(4) on the CPU over gloo: a 2 x 2 mesh, one capsule
    per data shard, every rank the same finite loss."""
    metrics = dryrun_multichip(4, device="cpu", backend="gloo")
    out = capsys.readouterr().out
    assert "mesh data=2 model=2 backend=gloo devices=cpu train_step ok" in out
    assert np.isfinite(metrics["total_loss"]) and np.isfinite(metrics["grad_norm"])
