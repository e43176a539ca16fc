"""The mesh, the ranks, and the placement of batches and training states —
counterpart of morig_tpu/parallel/sharding.py over torch.distributed.

    def step(rank, device):
        mesh = make_device_mesh(data=2, model=2)
        state = shard_state(stage.init_state(0, device=device), mesh,
                            tensor_parallel=True, reinit_opt=True)
        return stage.train_step(state, shard_batch(global_batch, mesh), generator,
                                mesh=mesh)

    spawn(step, world=4, backend="nccl", devices=["cuda:0", "cuda:1", "cuda:2", "cuda:3"])

Each rank runs on `devices[rank % len(devices)]`.  The backend is the
caller's: NCCL needs one card per rank and refuses fewer; gloo takes CPU
tensors and CUDA tensors (several ranks on one card), for the all_reduce
and broadcast that are all the port's collectives.  A rank's data index is
rank // model and its model index rank % model, the row-major order of the
JAX package's `make_device_mesh`.
"""
from __future__ import annotations

import dataclasses
import datetime
import io
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from morig_tpu_torch.nn.mlp import Dense
from morig_tpu_torch.parallel.mesh import DeviceMesh, gather_model
from morig_tpu_torch.train.trainer import MultiStepAdam, TrainState, adam

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 600.0


def make_device_mesh(data: int, model: int = 1, group=None) -> Optional[DeviceMesh]:
    """The data x model mesh over the ranks of `group` (the world when
    None), which must number data * model; every rank of the world calls
    it, as `dist.new_group` requires.  None on a rank outside `group`."""
    ranks = (list(range(dist.get_world_size())) if group is None
             else dist.get_process_group_ranks(group))
    if len(ranks) != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, got {len(ranks)}")
    me = dist.get_rank()
    d, k = divmod(ranks.index(me), model) if me in ranks else (None, None)
    model_group = data_group = None
    for i in range(data):
        g = dist.new_group([ranks[i * model + j] for j in range(model)])
        model_group = g if i == d else model_group
    for j in range(model):
        g = dist.new_group([ranks[i * model + j] for i in range(data)])
        data_group = g if j == k else data_group
    if d is None:
        return None
    return DeviceMesh(data, model, d, k, data_group, model_group)


def init_process_group(backend: str, rank: int, world: int, init_method: str,
                       device=None) -> torch.device:
    """Join a world of `world` ranks at `init_method` (e.g.
    "tcp://localhost:29500") as `rank`, on `device` (the CPU when None; a
    card is made the current one).  NCCL needs a card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device if device is not None else "cpu")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, backend, devices, init_method, threads, args, queue):
    """One spawned rank: join the world, run fn(rank, device, *args), send
    its result (saved with torch.save) or its traceback to the parent."""
    try:
        if threads:
            torch.set_num_threads(threads)
        device = init_process_group(backend, rank, world, init_method,
                                    devices[rank % len(devices)])
        out = fn(rank, device, *args)
        buf = io.BytesIO()
        torch.save(out, buf)
        queue.put((rank, buf.getvalue(), None))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, backend: str, devices: Sequence, args: tuple = (),
          threads: Optional[int] = None) -> list:
    """Run fn(rank, device, *args) on `world` ranks started with the
    `spawn` method (a CUDA context does not survive fork), joined over
    `backend` on localhost; rank r on devices[r % len(devices)], with
    `threads` intra-op threads each where given.  Returns each rank's
    result (fn's return value, through torch.save: tensors come back as
    they were, so move them to the CPU), in rank order.  A rank that raises
    or a world that outlives TIMEOUT_S seconds stops every rank and raises
    here.  Build the kernels before: the ranks load the built library."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    devices = [torch.device(d) for d in devices]
    if backend == "nccl" and (any(d.type != "cuda" for d in devices)
                              or len(set(devices)) < world):
        raise ValueError(f"the NCCL backend needs one distinct card per rank: {world} ranks "
                         f"on {[str(d) for d in devices]}; pass more cards or choose gloo")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = mp.start_processes(
        _rank_main, args=(fn, world, backend, devices, init_method, threads, args, queue),
        nprocs=world, join=False, start_method="spawn")
    results, errors = [None] * world, {}
    deadline = time.monotonic() + TIMEOUT_S

    def drain():
        while not queue.empty():
            rank, blob, err = queue.get()
            if err is not None:
                errors[rank] = err
            else:
                results[rank] = torch.load(io.BytesIO(blob), weights_only=False)

    try:
        while True:
            drain()
            try:
                if procs.join(timeout=0.05):
                    break
            except Exception as e:
                drain()
                first = min(errors) if errors else None
                raise RuntimeError(f"rank {first} of {world} failed:\n"
                                   f"{errors.get(first, e)}") from None
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join()
    drain()
    return results


def _batch_size(sample) -> int:
    for f in dataclasses.fields(sample):
        v = getattr(sample, f.name)
        if torch.is_tensor(v):
            return v.shape[0]
        if dataclasses.is_dataclass(v):
            return _batch_size(v)
    raise ValueError(f"{type(sample).__name__} holds no tensor")


def shard_batch(sample, mesh: DeviceMesh):
    """This rank's rows of a batch (PoseSample, RigSample, SkelSample,
    MeshBatch, ...): B / data consecutive rows at its data index, split
    field by field (every tensor field carries the batch on axis 0), so
    every rank of a model group gets the same rows.  A nested batch is
    rebuilt with `dataclasses.replace`, so a MeshBatch shard builds its own
    reverse tables (`tpl_rev`, `geo_rev`) and keeps `edge_tile`."""
    B = _batch_size(sample)
    if B % mesh.data:
        raise ValueError(f"a batch of {B} does not split over {mesh.data} data ranks")
    n = B // mesh.data
    start = mesh.data_index * n

    def split(obj, name):
        if torch.is_tensor(obj):
            if obj.dim() == 0 or obj.shape[0] != B:
                raise ValueError(f"field {name} of shape {tuple(obj.shape)} has no batch of "
                                 f"{B} on axis 0")
            return obj[start:start + n].clone()
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{f.name: split(getattr(obj, f.name), f.name)
                                               for f in dataclasses.fields(obj)})
        return obj

    return split(sample, type(sample).__name__)


def _broadcast(tensors: list, src: int = 0) -> None:
    """Rank src's values of `tensors` on every rank, one broadcast per
    dtype and device."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src)
        for t, v in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.copy_(v.view_as(t))


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers on every rank of the world."""
    _broadcast([t.data for t in module.parameters()] + list(module.buffers()))
    return module


def tp_param_spec(module: nn.Module, model: int, min_dim: int = 512) -> Optional[int]:
    """The axis over which tensor parallelism shards a module's parameters:
    0 (the output rows of the (out, in) weight, and the bias) for a `Dense`
    whose output width is at least min_dim and divides by `model`; None
    (replicated) for every other module and at model = 1.  The JAX
    function's rule for flax `kernel`/`bias` leaves: the edge layers' tail
    tables K1 and K6 read (`dense_1_kernel`, ...) are no Dense and stay
    whole, and their `lin_self`/`lin_nbr` are at most 256 wide."""
    if model == 1 or not isinstance(module, Dense):
        return None
    out = module.weight.shape[0]
    return 0 if out >= min_dim and out % model == 0 else None


def tp_layers(model: nn.Module, model_size: int) -> list[str]:
    """The names of the Dense modules `shard_state` shards over a model
    group of `model_size` ranks."""
    return [n for n, m in model.named_modules() if tp_param_spec(m, model_size) is not None]


def _fresh_tx(tx: MultiStepAdam) -> MultiStepAdam:
    """A new optimizer and schedule of tx's settings over the same
    parameters (as they are now)."""
    opt = tx.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    new = adam(params, float(tx.scheduler.base_lrs[0]), opt.defaults["weight_decay"])
    sched = torch.optim.lr_scheduler.MultiStepLR(
        new, milestones=sorted(tx.scheduler.milestones.elements()), gamma=tx.scheduler.gamma)
    return MultiStepAdam(new, sched, tx.clip_norm)


@torch.no_grad()
def shard_state(state: TrainState, mesh: DeviceMesh, tensor_parallel: bool = True,
                reinit_opt: bool = False) -> TrainState:
    """Place a TrainState on the mesh: rank 0's parameters and buffers on
    every rank; with `tensor_parallel`, each Dense `tp_param_spec` picks
    keeps its model index's slice of output rows (weight and bias, marked
    `tp_sharded`) and computes through parallel/mesh.py `tp_linear`.  The
    model is changed in place.  With `reinit_opt` the optimizer is built
    anew over the rank's own parameters (a fresh state only: a state past
    step 0 is refused, its moments would be lost); without, rank 0's
    moments are broadcast and sliced as the parameters are."""
    if reinit_opt and state.step > 0:
        raise ValueError(
            "shard_state(reinit_opt=True) would discard the optimizer moments of a "
            f"mid-training state (step={state.step}); use reinit_opt=False to reshard an "
            "existing optimizer state.")
    replicate(state.model)
    opt = state.tx.optimizer
    if not reinit_opt:
        _broadcast([v for s in opt.state.values() for v in s.values()
                    if torch.is_tensor(v) and v.dim() > 0])
    if tensor_parallel:
        for m in state.model.modules():
            if tp_param_spec(m, mesh.model) is None:
                continue
            n = m.weight.shape[0] // mesh.model
            rows = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
            for p in (m.weight, m.bias):
                if p is None:
                    continue
                for k, v in opt.state.get(p, {}).items():
                    if torch.is_tensor(v) and v.shape == p.shape:
                        opt.state[p][k] = v[rows].clone()
                p.data = p.data[rows].clone()
                p.tp_sharded = True
            m.tp = mesh
    tx = _fresh_tx(state.tx) if reinit_opt else state.tx
    return dataclasses.replace(state, tx=tx)


def sharded_names(model: nn.Module) -> set[str]:
    """The names of the parameters `shard_state` has sharded."""
    return {n for n, p in model.named_parameters() if getattr(p, "tp_sharded", False)}


def gather_tensor(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """A sharded parameter's (or its gradient's) slices over the model
    group as one tensor: the rows in model-index order."""
    return gather_model(t.detach().movedim(0, -1), mesh).movedim(-1, 0).contiguous()


@torch.no_grad()
def gather_state(state: TrainState, mesh: DeviceMesh) -> dict[str, torch.Tensor]:
    """The whole, unsharded parameters and buffers (a state dict) on every
    rank of the model group."""
    sharded = sharded_names(state.model)
    return {n: gather_tensor(t, mesh) if n in sharded else t.detach().clone()
            for n, t in state.model.state_dict(keep_vars=True).items()}
