"""Epoch-scanned training: chunks of epochs run from device-resident data
with one host sync per chunk — counterpart of morig_tpu/train/scanned.py.

`trainer.run_epochs` builds each batch on the host, uploads it and reads
each step's metrics back (`.tolist()`), so Python dispatches every op of a
step and the card waits on the host.  This runner keeps the JAX package's
design:

  * the whole dataset lives on the device once; `ScanBatcher.gather` turns a
    row of an integer schedule into a batch with pure index ops on the
    device, so no step uploads anything;
  * the steps of a chunk of `chunk_epochs` epochs run from one schedule
    copied once per chunk: on a CUDA state each stage's train step, eval
    step and epoch end are captured once into CUDA graphs
    (train/graphs.py) and each step is one replay, with no host sync inside
    the chunk (the host steps the learning-rate schedule between replays);
    on a CPU state the same programs run eagerly;
  * best-on-val rides on the device: the per-epoch train and val means, the
    lowest val loss, its epoch and a copy of the parameters and buffers
    (MaskedBatchNorm's running statistics are JAX's batch_stats) of the
    best epoch, taken with `torch.where`, are fetched once at the chunk's
    end.

Semantics are `run_epochs`': the same schedule draws (`epoch_schedule` is
the code path `epoch_batches` runs, called per epoch in order at the
chunk's start), the same generator stream, the same strict `<` best-on-val
rule, means per epoch.  As in the JAX package, `model_best.pt` holds the
best epoch's parameters and buffers with the chunk-end optimizer state, and
is written only when the chunk improved.  A stage's static flags (e.g.
`CorrPoseStage.train_vismask`) are constant within a chunk: chunks split at
`stage.vis_branch_start_epoch`, and the graphs are captured again when the
flags change.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from morig_tpu_torch.core import batch as B
from morig_tpu_torch.data.pose import MAX_CORR
from morig_tpu_torch.nn.gcu import windowed_tile
from morig_tpu_torch.train import graphs, trainer
from morig_tpu_torch.utils import profiling


@dataclasses.dataclass
class ScanBatcher:
    """Device-resident dataset + integer-schedule batching.

    gather:          maps one schedule row (dict of int64 device tensors) to
                     a batch, by index ops on the device only.
    schedule:        host fn (epoch, np rng) -> schedule dict of int64 numpy
                     arrays with leading axis K = steps_per_epoch.
    steps_per_epoch: K (constant across epochs; ragged tails are cycled by
                     the underlying dataset schedule).
    val_scheds:      schedule dict with leading axis n_val (deterministic,
                     built once; validation draws nothing).
    n_val:           number of validation batches.
    val_gather:      the validation rows' gather when validation reads
                     another dataset (`with_val_dataset`), else None.
    """

    gather: Callable[[dict], Any]
    schedule: Callable[[int, np.random.Generator], dict]
    steps_per_epoch: int
    val_scheds: dict
    n_val: int
    val_gather: Optional[Callable[[dict], Any]] = None


def _stack_sched(scheds: list) -> dict:
    return {k: np.stack([s[k] for s in scheds]) for k in scheds[0]}


def _index(x, idx: torch.Tensor):
    """Rows `idx` of every tensor of a batch (a MeshBatch keeps its
    edge_tile and builds its own reverse tables)."""
    if torch.is_tensor(x):
        return x[idx]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _index(getattr(x, f.name), idx)
                                         for f in dataclasses.fields(x)
                                         if f.name != "edge_tile"})
    return x


# ---------------------------------------------------------------------------
# batchers
# ---------------------------------------------------------------------------

def _pose_rows(sched: list) -> dict:
    """An epoch_schedule list of (model indices, src, tar) as schedule rows:
    idx (K, B), src and tar (K, 1) (one-element rows, so that the gather
    indexes with tensors only and never reads a value on the host)."""
    return dict(idx=np.asarray([s[0] for s in sched], np.int64),
                src=np.asarray([[s[1]] for s in sched], np.int64),
                tar=np.asarray([[s[2]] for s in sched], np.int64))


def pose_scan_batcher(ds, batch_size: int, kind: str, sequential: bool,
                      device="cuda") -> ScanBatcher:
    """Device-resident PoseDataset (single bucket) on `device` (the card
    unless the caller asks for another).  Per-frame stacks are uploaded
    once; `gather` assembles PoseSample batches with index ops alone
    (PoseDataset.batch semantics, data/pose.py), stacked with the dataset's
    `edge_tile` where every model's tables are local at it."""
    if len(set(ds.bucket_of)) != 1:
        raise ValueError("pose_scan_batcher needs one vertex bucket")
    V = ds.bucket_of[0]
    M = len(ds.models)
    nf = min(m.num_frames for m in ds.models)
    P = ds.models[0].pts_traj.shape[0]
    if any(m.pts_traj.shape[0] != P for m in ds.models):
        raise ValueError("pose_scan_batcher needs one point count")
    N = MAX_CORR

    entries = [ds._mesh_cache[i] for i in range(M)]
    mesh_full = B.stack_meshes(entries, device, edge_tile=windowed_tile(entries, ds.edge_tile))
    vtx = np.stack([np.stack([B.pad_to(m.vtx_traj[:, t, :].astype(np.float32), V)
                              for t in range(nf)]) for m in ds.models])     # (M, nf, V, 3)
    pts = np.stack([np.stack([m.pts_traj[:, t, :].astype(np.float32) for t in range(nf)])
                    for m in ds.models])                                    # (M, nf, P, 3)
    vis = np.stack([np.stack([B.pad_to(m.vismask[:, t].astype(np.float32), V)
                              for t in range(nf)]) for m in ds.models])     # (M, nf, V)
    v2p = np.zeros((M, nf, N, 2), np.int64)
    v2pm = np.zeros((M, nf, N), bool)
    p2v = np.zeros((M, nf, N, 2), np.int64)
    p2vm = np.zeros((M, nf, N), bool)
    for i, m in enumerate(ds.models):
        for t in range(nf):
            v2p[i, t], v2pm[i, t] = ds._corr_pad(m.corr_v2p, t)
            p2v[i, t], p2vm[i, t] = ds._corr_pad(m.corr_p2v, t)
    dev = {k: torch.as_tensor(v, device=device) for k, v in dict(
        vtx=vtx, pts=pts, vis=vis, v2p=v2p, v2pm=v2pm, p2v=p2v, p2vm=p2vm).items()}
    pts_mask = torch.ones((batch_size, P), dtype=torch.bool, device=device)

    def gather(sched):
        idx, src, tar = sched["idx"], sched["src"], sched["tar"]
        mesh = dataclasses.replace(
            mesh_full, verts=dev["vtx"][idx, src], vert_mask=mesh_full.vert_mask[idx],
            tpl_nbr=mesh_full.tpl_nbr[idx], tpl_mask=mesh_full.tpl_mask[idx],
            geo_nbr=mesh_full.geo_nbr[idx], geo_mask=mesh_full.geo_mask[idx])
        return B.PoseSample(
            mesh=mesh,
            points=B.PointBatch(dev["pts"][idx, tar], pts_mask),
            corr=B.CorrBatch(dev["v2p"][idx, tar], dev["v2pm"][idx, tar],
                             dev["p2v"][idx, tar], dev["p2vm"][idx, tar]),
            vismask=dev["vis"][idx, tar],
            gt_flow=dev["vtx"][idx, tar] - dev["vtx"][idx, src],
        )

    def schedule(epoch: int, rng: np.random.Generator) -> dict:
        return _pose_rows(ds.epoch_schedule(rng, batch_size, kind, sequential, train=True))

    vs = ds.epoch_schedule(np.random.default_rng(0), batch_size, kind, sequential, train=False)
    K = len(ds.epoch_schedule(np.random.default_rng(0), batch_size, kind, sequential,
                              train=True))
    return ScanBatcher(gather, schedule, K, _pose_rows(vs), len(vs))


def with_val_dataset(b_train: ScanBatcher, b_val: ScanBatcher) -> ScanBatcher:
    """Train on one dataset, validate on another (the campaign layout):
    the val gather reads the val dataset's device arrays."""
    b_train.val_scheds = b_val.val_scheds
    b_train.n_val = b_val.n_val
    b_train.val_gather = b_val.gather
    return b_train


def rig_scan_batcher(ds, batch_size: int, val_ds=None, device="cuda") -> ScanBatcher:
    """Device-resident RigDataset on `device`: one full-dataset RigSample
    (B = M) built by the host path, batches gathered by model index."""
    full = ds.batch(list(range(len(ds.models))), device=device)

    def schedule(epoch: int, rng: np.random.Generator) -> dict:
        return dict(idx=np.asarray(ds.epoch_schedule(rng, batch_size, train=True), np.int64))

    vds = val_ds if val_ds is not None else ds
    vs = vds.epoch_schedule(np.random.default_rng(0), batch_size, train=False)
    K = len(ds.epoch_schedule(np.random.default_rng(0), batch_size, train=True))
    b = ScanBatcher(lambda sched: _index(full, sched["idx"]), schedule, K,
                    dict(idx=np.asarray(vs, np.int64)), len(vs))
    if val_ds is not None:
        vfull = val_ds.batch(list(range(len(val_ds.models))), device=device)
        b.val_gather = lambda sched: _index(vfull, sched["idx"])
    return b


def const_scan_batcher(train_sample, val_sample=None) -> ScanBatcher:
    """A single constant batch per epoch (the skeleton stages: one SkelSample
    covering the dataset), on the device it was built on."""
    val_sample = val_sample if val_sample is not None else train_sample
    return ScanBatcher(
        gather=lambda sched: train_sample,
        schedule=lambda e, rng: dict(i=np.zeros((1,), np.int64)),
        steps_per_epoch=1,
        val_scheds=dict(i=np.zeros((1,), np.int64)),
        n_val=1,
        val_gather=lambda sched: val_sample,
    )


# ---------------------------------------------------------------------------
# the scanned epoch runner
# ---------------------------------------------------------------------------

def _chunk_ranges(start: int, epochs: int, chunk: int, boundary: Optional[int]):
    """[start, epochs) split into <=chunk-sized ranges, additionally split at
    `boundary` (a program-changing epoch, e.g. vis_branch_start_epoch)."""
    cuts = {start, epochs}
    if boundary is not None and start < boundary < epochs:
        cuts.add(boundary)
    edges = sorted(cuts)
    out = []
    for a, bnd in zip(edges[:-1], edges[1:]):
        e = a
        while e < bnd:
            out.append((e, min(e + chunk, bnd)))
            e = min(e + chunk, bnd)
    return out


def _row(sched: dict, cursor: torch.Tensor) -> dict:
    """Row `cursor` ((1,) int64 on the device) of a schedule, by index ops."""
    return {k: v.index_select(0, cursor)[0] for k, v in sched.items()}


def _flags(stage) -> tuple:
    """The stage's plain attributes: what a captured step takes as fixed."""
    return tuple(sorted((k, v) for k, v in vars(stage).items()
                        if isinstance(v, (bool, int, float, str))))


class _Carry:
    """The runner's device buffers, which its programs read and write in
    place: the chunk's schedule and the val schedule with their cursors,
    each step's metrics, the per-epoch means, and best-on-val (the lowest
    val loss, its epoch, the best parameters and buffers)."""

    def __init__(self, stage, state, batcher: ScanBatcher, generator, chunk_epochs: int,
                 init_lowest: float, init_best_epoch: int):
        dev = state.device
        self.stage, self.state, self.batcher, self.generator = stage, state, batcher, generator
        self.K, self.rows = batcher.steps_per_epoch, chunk_epochs * batcher.steps_per_epoch
        first = batcher.schedule(0, np.random.default_rng(0))
        self.sched = {k: torch.zeros((self.rows,) + v.shape[1:], dtype=torch.int64, device=dev)
                      for k, v in first.items()}
        self.val_sched = {k: torch.as_tensor(v, device=dev)
                          for k, v in batcher.val_scheds.items()}
        self.val_gather = batcher.val_gather or batcher.gather
        self.eval_generator = None
        if "generator" in inspect.signature(stage.eval_step).parameters:
            # a fresh generator seeded 0 per eval call, as eval_step's default
            self.eval_generator = torch.Generator(device=dev).manual_seed(0)
        i64 = dict(dtype=torch.int64, device=dev)
        self.cursor, self.val_cursor, self.epoch_cursor = (torch.zeros(1, **i64)
                                                           for _ in range(3))
        self.eids = torch.zeros(chunk_epochs, **i64)
        self.lowest = torch.full((1,), init_lowest, dtype=torch.float32, device=dev)
        self.best_epoch = torch.full((1,), init_best_epoch, **i64)
        self.best = [t.detach().clone() for t in self.weights()]
        self.chunk_epochs = chunk_epochs
        self.train_names = self.val_names = None
        self.train_log = self.val_log = self.train_mean = self.val_mean = None

    def reset(self) -> None:
        """The cursors to the first row."""
        for t in (self.cursor, self.val_cursor, self.epoch_cursor):
            t.zero_()

    def weights(self) -> list:
        """The tensors best-on-val copies: parameters, then buffers."""
        m = self.state.model
        return [*m.parameters(), *m.buffers()]

    def tensors(self) -> list:
        """Every buffer a program writes (what a warm-up must put back)."""
        logs = [t for t in (self.train_log, self.val_log, self.train_mean, self.val_mean)
                if t is not None]
        return [self.cursor, self.val_cursor, self.epoch_cursor, self.lowest, self.best_epoch,
                *self.best, *logs]

    def _log(self, metrics: dict, kind: str) -> torch.Tensor:
        """The metrics stacked; the logs allocated at the first call (a
        warm-up on the card, outside any graph)."""
        vals = torch.stack(list(metrics.values()))
        if kind == "train" and self.train_log is None:
            self.train_names = list(metrics)
            self.train_log = vals.new_zeros((self.rows, len(vals)))
            self.train_mean = vals.new_zeros((self.chunk_epochs, len(vals)))
        elif kind == "val" and self.val_log is None:
            self.val_names = list(metrics)
            self.val_log = vals.new_zeros((self.batcher.n_val, len(vals)))
            self.val_mean = vals.new_zeros((self.chunk_epochs, len(vals)))
        return vals[None]

    def train(self) -> None:
        """One train step on schedule row `cursor`; its metrics to that row."""
        batch = self.batcher.gather(_row(self.sched, self.cursor))
        m = self.stage.train_step(self.state, batch, self.generator, on_device=True)
        vals = self._log(m, "train")
        self.train_log.index_copy_(0, self.cursor, vals)
        self.cursor.add_(1)

    def val(self) -> None:
        """One eval step on val row `val_cursor`; its metrics to that row."""
        batch = self.val_gather(_row(self.val_sched, self.val_cursor))
        kw = {} if self.eval_generator is None else {"generator": self.eval_generator}
        m = self.stage.eval_step(self.state, batch, on_device=True, **kw)
        vals = self._log(m, "val")
        self.val_log.index_copy_(0, self.val_cursor, vals)
        self.val_cursor.add_(1)

    @torch.no_grad()
    def epoch_end(self) -> None:
        """The epoch's train and val means into row `epoch_cursor`, then
        best-on-val: where the val total loss (else loss, else 0) is below
        the lowest, it, the epoch and the weights become the best."""
        e = self.epoch_cursor
        rows = self.train_log.view(self.chunk_epochs, self.K, -1).index_select(0, e)[0]
        self.train_mean.index_copy_(0, e, rows.mean(0)[None])
        vmean = self.val_log.mean(0)
        self.val_mean.index_copy_(0, e, vmean[None])
        names = self.val_names
        key = "total_loss" if "total_loss" in names else "loss" if "loss" in names else None
        score = vmean[names.index(key)][None] if key else torch.zeros_like(self.lowest)
        better = score < self.lowest
        for b, w in zip(self.best, self.weights()):
            b.copy_(torch.where(better[0], w, b))
        self.lowest.copy_(torch.where(better, score, self.lowest))
        self.best_epoch.copy_(torch.where(better, self.eids.index_select(0, e), self.best_epoch))
        self.val_cursor.zero_()
        self.epoch_cursor.add_(1)

    def best_state_dict(self) -> dict:
        """The model's state dict with the best weights in place."""
        sd = self.state.model.state_dict()
        names = [n for n, _ in self.state.model.named_parameters()] + \
                [n for n, _ in self.state.model.named_buffers()]
        sd.update((n, b) for n, b in zip(names, self.best) if n in sd)
        return sd


CHUNK_RANGE = "run_epochs_scanned chunk"


def _train_step(programs: graphs.Programs, state: trainer.TrainState) -> None:
    """One train program call; after a replay the host's part of the step
    (the schedule step and the step count, which the captured Python did
    once at capture)."""
    programs("train")
    if programs.graphs:
        state.tx.scheduler.step()
        state.step += 1


def _run_chunk(programs: graphs.Programs, carry: _Carry, host: dict, eids: torch.Tensor,
               C: int) -> None:
    """A chunk of C epochs: its schedule copied in once, then per epoch K
    train steps, the val steps and the epoch end, each a program call (a
    replay on the card)."""
    state, K = carry.state, carry.K
    for k, v in host.items():
        carry.sched[k][:C * K].copy_(v, non_blocking=True)
    carry.eids.copy_(eids, non_blocking=True)
    carry.reset()
    for _ in range(C):
        for _ in range(K):
            _train_step(programs, state)
        for _ in range(carry.batcher.n_val):
            if carry.eval_generator is not None:
                carry.eval_generator.manual_seed(0)
            programs("val")
        programs("epoch")


def run_epochs_scanned(
    stage,
    state: trainer.TrainState,
    batcher: ScanBatcher,
    *,
    epochs: int,
    checkpoint_dir: Optional[str] = None,
    logger: Optional[trainer.MetricLogger] = None,
    generator: Optional[torch.Generator] = None,
    rng_np: Optional[np.random.Generator] = None,
    start_epoch: int = 0,
    init_lowest: float = math.inf,
    init_best_epoch: int = -1,
    chunk_epochs: int = 25,
    early_stop_patience: Optional[int] = None,
    stats: Optional[dict] = None,
):
    """`trainer.run_epochs` (less test batches) over the device-resident
    `batcher`: the same returns (final state, best_epoch), logs (plus each
    epoch's `epoch_wall_s`, the chunk's wall time split evenly) and
    checkpoints, with one host sync per `chunk_epochs` epochs.  `generator`
    draws the training randomness (a seeded one on the model's device when
    None), `rng_np` the schedules.

    early_stop_patience: stop (at a chunk boundary) once the best-on-val
    epoch is this many epochs or more in the past.

    `stats` (a dict, filled when given): chunks, host fetches, captures
    (graph captures on a CUDA state) with each capture's launches per replay
    of each program, steps, each chunk's wall seconds and whether it
    captured.  The replays of a
    chunk are one `CHUNK_RANGE` range in a trace (utils/profiling.py).
    On a CUDA state the replays of a chunk run under
    `torch.cuda.set_sync_debug_mode("error")`: a step that syncs with the
    host raises."""
    from morig_tpu_torch.train import checkpoint as ckpt

    logger = logger or trainer.MetricLogger(None)
    dev = state.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    rng_np = rng_np if rng_np is not None else np.random.default_rng(0)
    stats = stats if stats is not None else {}
    stats.update(chunks=0, fetches=0, captures=0, steps=0, chunk_s=[], per_replay=[],
                 captured=[])
    K = batcher.steps_per_epoch
    carry = _Carry(stage, state, batcher, generator, chunk_epochs, init_lowest, init_best_epoch)
    gens = {"train": [generator]}
    if carry.eval_generator is not None:
        gens["val"] = [carry.eval_generator]
    programs = graphs.Programs(state, {"train": carry.train, "val": carry.val,
                                       "epoch": carry.epoch_end}, gens)
    captured_flags = None
    prev_lowest = float(init_lowest)
    best_epoch = init_best_epoch

    boundary = getattr(stage, "vis_branch_start_epoch", None)
    for e0, e1 in _chunk_ranges(start_epoch, epochs, chunk_epochs, boundary):
        stage.on_epoch(e0)   # static flags as of this chunk (constant inside)
        C = e1 - e0
        scheds = _stack_sched([batcher.schedule(e, rng_np) for e in range(e0, e1)])
        host = {k: torch.from_numpy(np.ascontiguousarray(v.reshape((C * K,) + v.shape[2:])))
                for k, v in scheds.items()}
        eids = torch.arange(e0, e0 + chunk_epochs, dtype=torch.int64)
        if programs.on_card:
            host = {k: v.pin_memory() for k, v in host.items()}
            eids = eids.pin_memory()

        t_chunk0 = time.time()
        stats["captured"].append(programs.on_card and _flags(stage) != captured_flags)
        if stats["captured"][-1]:
            carry.reset()     # the warm-up reads schedule row 0, epoch row 0
            programs.capture(carry.tensors())
            captured_flags = _flags(stage)
            stats["captures"] += 1
            stats["per_replay"].append({n: g.launches for n, g in programs.graphs.items()})
        lrs = [g["lr"] for g in state.tx.optimizer.param_groups]
        sync_mode = torch.cuda.get_sync_debug_mode() if programs.on_card else None
        if programs.on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with profiling.annotate(CHUNK_RANGE):
                _run_chunk(programs, carry, host, eids, C)
        finally:
            if programs.on_card:
                torch.cuda.set_sync_debug_mode(sync_mode)
        if programs.graphs and any(g["lr"] is not lr
                                   for g, lr in zip(state.tx.optimizer.param_groups, lrs)):
            raise RuntimeError("the schedule replaced the learning-rate tensor the graph reads")
        fetched = torch.cat([carry.train_mean[:C].flatten(), carry.val_mean[:C].flatten(),
                             carry.lowest, carry.best_epoch.to(torch.float32)]).double().cpu()
        t_chunk1 = time.time()
        stats["fetches"] += 1
        stats["chunks"] += 1
        stats["steps"] += C * K
        stats["chunk_s"].append(t_chunk1 - t_chunk0)

        nt, nv = len(carry.train_names), len(carry.val_names)
        tlog = fetched[:C * nt].view(C, nt).tolist()
        vlog = fetched[C * nt:C * (nt + nv)].view(C, nv).tolist()
        low_f, best_epoch = float(fetched[-2]), int(fetched[-1])
        # epochs inside a chunk are alike, so the per-epoch completion time
        # is the chunk's wall time split evenly, measured at the fetch
        epoch_s = (t_chunk1 - t_chunk0) / C
        for j, e in enumerate(range(e0, e1)):
            t_e = t_chunk0 + (j + 1) * epoch_s
            logger.log(e + 1, "train", dict(zip(carry.train_names, tlog[j])),
                       time_s=t_e, epoch_wall_s=round(epoch_s, 4))
            logger.log(e + 1, "val", dict(zip(carry.val_names, vlog[j])),
                       time_s=t_e, epoch_wall_s=round(epoch_s, 4))

        if checkpoint_dir:
            if low_f < prev_lowest:   # best improved somewhere in this chunk
                ckpt.save_checkpoint(state, checkpoint_dir, filename="model_best.pt",
                                     model_state=carry.best_state_dict(),
                                     extra={"epoch": best_epoch + 1, "lowest_loss": low_f})
            ckpt.save_checkpoint(state, checkpoint_dir, extra={"epoch": e1, "lowest_loss": low_f})
        prev_lowest = min(prev_lowest, low_f)

        if early_stop_patience is not None and e1 - (best_epoch + 1) >= early_stop_patience:
            print(f"early stop at epoch {e1}: best epoch {best_epoch + 1} is "
                  f"{e1 - best_epoch - 1} epochs old (patience {early_stop_patience})")
            break

    return state, best_epoch


def step_program(stage, state: trainer.TrainState, batcher: ScanBatcher,
                 generator: torch.Generator) -> Callable[[], None]:
    """The runner's train step on the batcher's first training row (epoch 0
    of `default_rng(0)`'s schedule) as a program of its own, for profiling
    one step: on a CUDA state captured here and each call a replay (the
    host steps the schedule after it), on a CPU state an eager call.  Each
    call trains `state` one more step."""
    carry = _Carry(stage, state, batcher, generator, 1, math.inf, -1)
    for k, v in batcher.schedule(0, np.random.default_rng(0)).items():
        carry.sched[k][:1].copy_(torch.as_tensor(v[:1]))
    programs = graphs.Programs(state, {"train": carry.train}, {"train": [generator]})
    if programs.on_card:
        programs.capture(carry.tensors())

    def call() -> None:
        carry.reset()
        _train_step(programs, state)

    return call
