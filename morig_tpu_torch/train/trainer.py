"""Generic training machinery: optimizer, state, loops, metric logging —
counterpart of morig_tpu/train/trainer.py.

The optimizer is the JAX package's optax chain written with torch's own
pieces: global-norm clipping at 10, then Adam with L2-coupled weight decay
(torch's `Adam(weight_decay=...)` adds wd * param to the gradient, as
optax's `add_decayed_weights` before `adam` does; not AdamW), under a
piecewise-constant multi-step learning rate counted in optimizer steps.

On a mesh (parallel/) the gradients are summed over the data group before
the clip, and the clip's global norm counts each parameter once: the
replicated ones on each rank, the slices of the tensor-parallel ones
(`tp_sharded`) summed over the model group.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass
class MultiStepAdam:
    """Adam + MultiStepLR + global-norm clip, stepped together."""

    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    clip_norm: float = 10.0
    # set while a step is captured in a CUDA graph: a schedule step there
    # would bake the learning rate into the graph, so the replays' caller
    # steps the schedule on the host after each replay instead
    defer_schedule: bool = False

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, mesh=None) -> torch.Tensor:
        """Clip the gradients by their global norm, take one Adam step and
        one schedule step.  Returns the global norm before the clip (a
        device scalar; reading it is left to the caller).  On a `mesh` the
        norm of the sharded slices is summed over its model group."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
        if mesh is None or mesh.model == 1:
            norm = torch.linalg.vector_norm(norms)
        else:
            sharded = torch.tensor([getattr(p, "tp_sharded", False) for p in params],
                                   device=norms.device)
            sq = norms.square()
            shard_sq = torch.where(sharded, sq, torch.zeros_like(sq)).sum()
            dist.all_reduce(shard_sq, group=mesh.model_group)
            norm = torch.sqrt(torch.where(sharded, torch.zeros_like(sq), sq).sum() + shard_sq)
        # optax clip_by_global_norm: g / norm * max_norm where norm >= max_norm
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        if not self.defer_schedule:
            self.scheduler.step()
        return norm

    def conform(self) -> None:
        """Put each parameter group in the form its device takes (after a
        state dict from the other form, or from the other device, was
        loaded): on the card capturable, with the learning rate a device
        tensor and the step counts on the device; on the CPU the plain
        form."""
        for group in self.optimizer.param_groups:
            dev = group["params"][0].device
            card = dev.type == "cuda"
            lr = group["lr"]
            if card and not (torch.is_tensor(lr) and lr.device == dev):
                group["lr"] = torch.tensor(float(lr), device=dev)
            elif not card and torch.is_tensor(lr):
                group["lr"] = float(lr)
            group["capturable"] = card
            for p in group["params"]:
                st = self.optimizer.state.get(p, {})
                if torch.is_tensor(st.get("step")):
                    st["step"] = st["step"].to(dev if card else "cpu", torch.float32)


def adam(params, lr: float, weight_decay: float) -> torch.optim.Adam:
    """torch's Adam with L2 decay in the form the parameters' device takes:
    on the card capturable, the learning rate a device tensor (a graph
    replay reads it where the schedule wrote it); on the CPU the plain
    form."""
    params = list(params)
    dev = params[0].device
    if dev.type == "cuda":
        return torch.optim.Adam(params, lr=torch.tensor(lr, device=dev),
                                weight_decay=weight_decay, capturable=True)
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


def multistep_adam(params, lr: float, milestones: Sequence[int], gamma: float,
                   weight_decay: float, steps_per_epoch: int = 1,
                   clip_norm: float = 10.0) -> MultiStepAdam:
    """Adam with L2 decay, the learning rate multiplied by gamma at each
    milestone epoch (milestones x steps_per_epoch optimizer steps), and the
    gradients clipped to a global norm of clip_norm before each step (`adam`'s
    form for the parameters' device)."""
    opt = adam(params, lr, weight_decay)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones=[int(m) * steps_per_epoch for m in milestones], gamma=gamma)
    return MultiStepAdam(opt, sched, clip_norm)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and schedule (`tx`) and the step count."""

    model: torch.nn.Module
    tx: MultiStepAdam
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_gradients(self, mesh=None) -> torch.Tensor:
        """One optimizer step on the gradients the model holds, on a `mesh`
        first summed over its data group; returns the global gradient norm
        before the clip."""
        if mesh is not None and mesh.data > 1:
            sum_gradients(self.model, mesh.data_group)
        norm = self.tx.step(mesh)
        self.step += 1
        return norm


def sum_gradients(model: torch.nn.Module, group) -> None:
    """Every gradient the model holds summed over `group`, in one
    all-reduce of their concatenation."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, s in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(s.view_as(g))


class Meter:
    """Streaming average."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricLogger:
    """Structured JSONL metric log + stdout, one line per (epoch, split)."""

    def __init__(self, logdir: Optional[str]):
        self.logdir = logdir
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self.f = open(os.path.join(logdir, "metrics.jsonl"), "a")
        else:
            self.f = None

    def log(self, epoch: int, split: str, metrics: dict, time_s: Optional[float] = None,
            **extra_fields):
        """One record: epoch, split, time (`time_s`, now when None), the
        extra fields (e.g. the scanned runner's `epoch_wall_s`), then the
        metrics."""
        record = {"epoch": epoch, "split": split,
                  "time": time.time() if time_s is None else time_s,
                  **extra_fields, **metrics}
        line = " ".join(f"{split}_{k}: {v:.6f}." for k, v in metrics.items())
        print(f"Epoch{epoch}. {line}")
        if self.f:
            self.f.write(json.dumps(record) + "\n")
            self.f.flush()

    def close(self):
        if self.f:
            self.f.close()


def run_epochs(
    stage,
    state: TrainState,
    train_batches: Callable[[int], Iterable],
    val_batches: Callable[[], Iterable],
    test_batches: Optional[Callable[[], Iterable]],
    epochs: int,
    checkpoint_dir: Optional[str] = None,
    logger: Optional[MetricLogger] = None,
    generator: Optional[torch.Generator] = None,
    start_epoch: int = 0,
    init_lowest: float = math.inf,
    init_best_epoch: int = -1,
):
    """The shared epoch loop over epochs start_epoch..epochs-1: train / val /
    test, then a checkpoint each epoch and a `model_best` copy whenever the
    validation total loss improves.  `generator` draws the training
    randomness (a seeded one on the model's device when None).  A resumed
    run passes its checkpoint's epoch as `start_epoch` and the best-on-val
    it had reached as `init_lowest` / `init_best_epoch` (the `lowest_loss`
    and, less one, the `epoch` of model_best's metadata), so the resumed
    epochs neither overwrite a better model_best nor report best_epoch -1
    when none of them improves.  Returns (state, best_epoch)."""
    from morig_tpu_torch.train import checkpoint as ckpt

    logger = logger or MetricLogger(None)
    if generator is None:
        generator = torch.Generator(device=state.device).manual_seed(0)
    lowest = init_lowest
    best_epoch = init_best_epoch
    for epoch in range(start_epoch, epochs):
        stage.on_epoch(epoch)
        meters: dict[str, Meter] = {}
        for batch in train_batches(epoch):
            for k, v in stage.train_step(state, batch, generator).items():
                meters.setdefault(k, Meter()).update(v)
        logger.log(epoch + 1, "train", {k: m.avg for k, m in meters.items()})

        val = evaluate(stage, state, val_batches())
        logger.log(epoch + 1, "val", val)
        if test_batches is not None:
            logger.log(epoch + 1, "test", evaluate(stage, state, test_batches()))

        score = val.get("total_loss", val.get("loss", 0.0))
        is_best = score < lowest
        if is_best:
            lowest = score
            best_epoch = epoch
        if checkpoint_dir:
            ckpt.save_checkpoint(state, checkpoint_dir, is_best=is_best,
                                 extra={"epoch": epoch + 1, "lowest_loss": lowest})
    return state, best_epoch


def evaluate(stage, state: TrainState, batches: Iterable) -> dict:
    meters: dict[str, Meter] = {}
    for batch in batches:
        for k, v in stage.eval_step(state, batch).items():
            meters.setdefault(k, Meter()).update(v)
    return {k: m.avg for k, m in meters.items()}
