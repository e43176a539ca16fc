"""Repeat a seeded training run and compare the two bit for bit.

On one card a training step of the port repeats exactly: every sum is taken
in an order that depends only on the shapes and the kernels' grids (K6's
db_table and the backward of the gathers through the ordered row scatter,
dW2 and the vector sums through fixed-order sums of partials).  `run_steps`
records what a run computes and `first_difference` names the first tensor
in which two runs part, so a check reads

    a = run_steps(stage, batch, 3, device="cuda")
    b = run_steps(stage, batch, 3, device="cuda")
    assert first_difference(a, b) is None

The guarantee's scope is one card model and grid: another card, another
number of SMs (the persistent grids) or another PyTorch may sum in another
order.
"""
from __future__ import annotations

from typing import Optional

import torch


def run_steps(stage, batch, steps: int = 1, seed: int = 0, device="cuda",
              make_state=None) -> list[tuple[str, torch.Tensor]]:
    """`stage.init_state(seed, device=device)` (or `make_state()`) and
    `steps` train steps on `batch`, step s drawing from a generator seeded
    with s.  Returns named copies, in order: each step's metrics, then
    every parameter's gradient as the step used it (after the clip), then
    the parameters after the last step and the buffers (running
    statistics)."""
    state = make_state() if make_state is not None else stage.init_state(seed, device=device)
    dev = state.device
    named = []
    for s in range(steps):
        metrics = stage.train_step(state, batch, torch.Generator(device=dev).manual_seed(s))
        named += [(f"step {s} {k}", torch.tensor(v, dtype=torch.float64))
                  for k, v in metrics.items()]
        named += [(f"step {s} grad {n}", p.grad.detach().clone())
                  for n, p in state.model.named_parameters() if p.grad is not None]
    named += [(f"param {n}", p.detach().clone()) for n, p in state.model.named_parameters()]
    named += [(f"buffer {n}", b.detach().clone()) for n, b in state.model.named_buffers()]
    return named


def first_difference(a, b) -> Optional[str]:
    """The name of the first tensor of two `run_steps` records that is not
    `torch.equal` in both (or where the records disagree in their names),
    None where every tensor is equal."""
    if [n for n, _ in a] != [n for n, _ in b]:
        return "the runs recorded different tensors"
    for (name, x), (_, y) in zip(a, b):
        if not torch.equal(x, y):
            return name
    return None
