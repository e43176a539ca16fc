"""The split comparison of morig_tpu_torch/parallel/steps.py
(`split_sources`) on the CPU: rank 0 of a data = 2 step against the
one-device step on the global batch, call by call, each aten operation,
module and kernel wrapper call of the forward and the backward held bit
for bit on rank 0's rows.

On the CPU a rank computes its rows as the one-device step on the whole
batch does, so at test_torch_parallel.py's small CASES the comparison
finds no call whose inputs are equal and whose output is not.  Given one
module patched so that its output depends on how many rows it gets, it
names exactly that module.  The ranks run on 2 CPU processes over gloo with
one thread each; the whole module takes about a minute and a half.
"""
import dataclasses

import pytest
import torch

from morig_tpu_torch.parallel import sharding, steps
from test_torch_parallel import CASES

torch.set_num_threads(1)

SPLIT_CASES = ["deform", "rig_jointnet", "bone"]
# the module made to depend on its row count, and the case that carries it
ROW_DEPENDENT = "shape_encoder.gcu_2"
PATCHED = dataclasses.replace(CASES["bone"], name="bone_row_dependent",
                              model_attrs=(("row_dependent", ROW_DEPENDENT),))
BUILD = steps.build


def row_dependent_build(case, device):
    """`steps.build`, then the module named by the model's `row_dependent`
    attribute (where set) adds 1e-3 x its input's row count to its output."""
    stage, state = BUILD(case, device)
    name = getattr(state.model, "row_dependent", None)
    if name:
        module = dict(state.model.named_modules())[name]
        forward = module.forward
        module.forward = lambda x, *args, **kw: forward(x, *args, **kw) + 1e-3 * x.shape[0]
    return stage, state


def patched_split_rank(rank, device, data, model, cases):
    steps.build = row_dependent_build
    return steps.split_rank(rank, device, data, model, cases)


@pytest.fixture(scope="module")
def split():
    cases = [CASES[n] for n in SPLIT_CASES] + [PATCHED]
    original, steps.build = steps.build, row_dependent_build
    try:
        ones = [steps.record_case(c, "cpu", None, parts=2) for c in cases]
    finally:
        steps.build = original
    ranks = sharding.spawn(patched_split_rank, 2, "gloo", ["cpu"], args=(2, 1, cases),
                           threads=1)
    return {c.name: steps.split_result([r[i] for r in ranks], one, 2)
            for i, (c, one) in enumerate(zip(cases, ones))}


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_rows_compute_as_in_the_whole_batch(name, split):
    """Each rank's calls match the one-device step's (all but the mesh's
    own: its all-reduces and reverse tables) and none is a source; the
    backward is recorded too."""
    diff = split[name]
    assert diff["first"] is None, steps.describe(diff)
    assert diff["phases"]["forward"] > 0 and diff["phases"]["backward"] > 0
    assert diff["matched"] >= 0.99 * diff["calls"] and diff["compared"] > diff["calls"] // 3


def test_split_comparison_names_a_row_dependent_module(split):
    """With one module's output made to depend on its row count, that module
    is the only source, named by its path in the model."""
    diff = split["bone_row_dependent"]
    assert [s["module"] for s in diff["sources"]] == [ROW_DEPENDENT], steps.describe(diff)
    assert diff["first"]["phase"] == "forward" and diff["first"]["inputs equal"]
