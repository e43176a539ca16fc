"""CUDA-graph capture and replay of the scanned runner's device programs
(train/scanned.py): the card's form of the JAX package's "the epoch loop is
part of the compiled program" (morig_tpu/train/scanned.py).

A program is a function of static buffers: it reads what it needs from
tensors that outlive it (a dataset on the device, a schedule row picked by a
device cursor, the model's parameters and its optimizer's state) and writes
what it computes into others, so that it can run again with no argument.
`Programs` runs them eagerly on a CPU state.  On a CUDA state it first warms
each one up on a side stream, so that every cache a first call builds is
built outside the graph (K1's W2 index, an H2D copy from numpy,
kernels/edge_fused.py `wgmma_w2_layout`; the kernels' shared-memory
attributes, `cudaFuncSetAttribute` in csrc/; cuBLAS's workspace; Adam's
state), puts back every tensor the warm-up changed (`Snapshot`), and
captures each program into a CUDA graph that each call then replays.  A
capture that fails raises: nothing runs the eager programs in its place on
the card.

Random draws: the generators a program draws from are registered with its
graph, so each replay draws what the eager call at that point of the
generator's stream would draw.

Launch counts: the kernel wrappers count in Python, which a replay does not
run.  A capture records what its Python counted (`Graph.launches`, per
replay) and puts the wrappers' counts back, since nothing was launched; each
replay adds its graph's launches to `REPLAYED` (`replayed_launches`,
`reset_replayed`).
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch

from morig_tpu_torch.kernels import edge_fused, gather_fused, gemm, knn_fused, narrow_edge
from morig_tpu_torch.nn import gcu
from morig_tpu_torch.train.trainer import TrainState

# the counting wrappers, by kernel
COUNTED = {"K1": edge_fused.fused_edge_mlp, "K2": knn_fused.knn_batched,
           "K3": gather_fused.gather_rows, "K4": knn_fused.knn_topk,
           "K5": edge_fused.fused_edge_mlp_windowed, "K6": edge_fused.fused_edge_mlp_bwd,
           "KS": gather_fused.scatter_rows, "KG": gemm.gemm, "KN": narrow_edge.narrow_edge_fwd,
           "KNB": narrow_edge.narrow_edge_bwd, "plain_edge": gcu.plain_edge}
REPLAYED = dict.fromkeys(COUNTED, 0)


def counts() -> dict:
    return {k: f.launches for k, f in COUNTED.items()}


def replayed_launches() -> dict:
    """The launches of every replay since the last `reset_replayed`."""
    return dict(REPLAYED)


def reset_replayed() -> None:
    for k in REPLAYED:
        REPLAYED[k] = 0


class Snapshot:
    """What running a program changes, to put back in place (so that every
    address a graph holds stays valid): the model's parameters and buffers,
    the optimizer's state (a state the warm-up created is zeroed, which is
    Adam's fresh state), the schedule and its learning rates, the step count,
    `tensors` (the caller's buffers) and the generators' states."""

    def __init__(self, state: TrainState, tensors: Sequence[torch.Tensor],
                 generators: Sequence[torch.Generator]):
        self.state, self.generators = state, list(generators)
        self.tensors = [*state.model.parameters(), *state.model.buffers(), *tensors]
        with torch.no_grad():
            self.saved = [t.detach().clone() for t in self.tensors]
        opt = state.tx.optimizer
        self.opt = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                    for p, st in opt.state.items()}
        self.lrs = [g["lr"].clone() if torch.is_tensor(g["lr"]) else g["lr"]
                    for g in opt.param_groups]
        self.schedule = copy.deepcopy(state.tx.scheduler.state_dict())
        self.step = state.step
        self.generator_states = [g.get_state() for g in self.generators]

    @torch.no_grad()
    def restore(self) -> None:
        for t, s in zip(self.tensors, self.saved):
            t.copy_(s)
        opt = self.state.tx.optimizer
        for p, st in opt.state.items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    v.copy_(self.opt[p][k]) if p in self.opt else v.zero_()
        for g, lr in zip(opt.param_groups, self.lrs):
            if torch.is_tensor(lr):
                g["lr"].copy_(lr)
            else:
                g["lr"] = lr
        self.state.tx.scheduler.load_state_dict(copy.deepcopy(self.schedule))
        self.state.step = self.step
        for g, s in zip(self.generators, self.generator_states):
            g.set_state(s)


class Graph:
    """`fn` captured into one CUDA graph with `generators` registered;
    `launches`: the kernel launches of one replay."""

    def __init__(self, fn: Callable[[], None], name: str,
                 generators: Sequence[torch.Generator] = ()):
        self.name = name
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = counts()
        try:
            with torch.cuda.graph(self.graph):
                fn()
        except Exception as err:
            raise RuntimeError(f"CUDA graph capture of the {name} program failed: {err}") from err
        finally:
            after = counts()
            for k, f in COUNTED.items():
                f.launches = before[k]
        self.launches = {k: after[k] - before[k] for k in COUNTED}

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            REPLAYED[k] += n


class Programs:
    """Named programs over static buffers: called eagerly on a CPU state,
    replayed from CUDA graphs on a CUDA state once `capture` has run.
    `generators[name]`: the generators that program draws from."""

    def __init__(self, state: TrainState, fns: dict, generators: Optional[dict] = None):
        self.state, self.fns = state, fns
        self.generators = generators or {}
        self.graphs: dict = {}
        self.on_card = state.device.type == "cuda"

    def capture(self, tensors: Sequence[torch.Tensor]) -> None:
        """(A CUDA state.)  Warm every program up once on a side stream, in
        order, put back what that changed (the state, `tensors`, the
        generators), then capture each program into its graph, the
        schedule left to the host (`MultiStepAdam.defer_schedule`).  A
        failure raises."""
        gens = list({id(g): g for gs in self.generators.values() for g in gs}.values())
        snap = Snapshot(self.state, tensors, gens)
        dev = self.state.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for fn in self.fns.values():
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        snap.restore()
        self.graphs = {}
        tx = self.state.tx
        tx.defer_schedule = True
        try:
            for name, fn in self.fns.items():
                self.graphs[name] = Graph(fn, name, self.generators.get(name, ()))
        finally:
            tx.defer_schedule = False
            snap.restore()

    def __call__(self, name: str) -> None:
        if self.graphs:
            self.graphs[name].replay()
        else:
            self.fns[name]()
