"""Generic training machinery: optimizer, state, loops, metric logging —
counterpart of morig_tpu/train/trainer.py.

The optimizer is the JAX package's optax chain written with torch's own
pieces: global-norm clipping at 10, then Adam with L2-coupled weight decay
(torch's `Adam(weight_decay=...)` adds wd * param to the gradient, as
optax's `add_decayed_weights` before `adam` does; not AdamW), under a
piecewise-constant multi-step learning rate counted in optimizer steps.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Iterable, Optional, Sequence

import torch


@dataclasses.dataclass
class MultiStepAdam:
    """Adam + MultiStepLR + global-norm clip, stepped together."""

    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    clip_norm: float = 10.0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip the gradients by their global norm, take one Adam step and
        one schedule step.  Returns the global norm before the clip (a
        device scalar; reading it is left to the caller)."""
        grads = [p.grad for g in self.optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # optax clip_by_global_norm: g / norm * max_norm where norm >= max_norm
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        self.scheduler.step()
        return norm


def multistep_adam(params, lr: float, milestones: Sequence[int], gamma: float,
                   weight_decay: float, steps_per_epoch: int = 1,
                   clip_norm: float = 10.0) -> MultiStepAdam:
    """Adam with L2 decay, the learning rate multiplied by gamma at each
    milestone epoch (milestones x steps_per_epoch optimizer steps), and the
    gradients clipped to a global norm of clip_norm before each step."""
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
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

    def apply_gradients(self) -> torch.Tensor:
        """One optimizer step on the gradients the model holds; returns the
        global gradient norm before the clip."""
        norm = self.tx.step()
        self.step += 1
        return norm


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

    def log(self, epoch: int, split: str, metrics: dict):
        record = {"epoch": epoch, "split": split, "time": time.time(), **metrics}
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
):
    """The shared epoch loop: train / val / test, then a checkpoint each
    epoch and a `model_best` copy whenever the validation total loss
    improves.  `generator` draws the training randomness (a seeded one on
    the model's device when None).  Returns (state, best_epoch)."""
    from morig_tpu_torch.train import checkpoint as ckpt

    logger = logger or MetricLogger(None)
    if generator is None:
        generator = torch.Generator(device=state.device).manual_seed(0)
    lowest = math.inf
    best_epoch = -1
    for epoch in range(epochs):
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
