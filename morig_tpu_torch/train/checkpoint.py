"""Checkpoints of a TrainState in the port's own format — counterpart of
morig_tpu/train/checkpoint.py `save_checkpoint` / `load_checkpoint`.

A checkpoint is one `torch.save` file of the model's, the optimizer's and
the schedule's state dicts and the step count, written atomically (a
temporary file, then a rename), with the caller's metadata beside it as
JSON; `model_best.pt` is a copy made when validation improves.  The JAX
package's flax msgpack files are not read here.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from morig_tpu_torch.train.trainer import TrainState


def _state_dict(state: TrainState) -> dict:
    return {"step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.tx.optimizer.state_dict(),
            "scheduler": state.tx.scheduler.state_dict()}


def save_checkpoint(state: TrainState, checkpoint_dir: str, is_best: bool = False,
                    extra: Optional[dict] = None) -> str:
    """Write `checkpoint_dir/checkpoint.pt` (and `.json` metadata from
    `extra`); with is_best, copy both to `model_best.pt`.  Returns the path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "checkpoint.pt")
    torch.save(_state_dict(state), path + ".tmp")
    os.replace(path + ".tmp", path)
    if extra is not None:
        with open(path + ".json.tmp", "w") as f:
            json.dump({k: float(v) for k, v in extra.items()}, f)
        os.replace(path + ".json.tmp", path + ".json")
    if is_best:
        best = os.path.join(checkpoint_dir, "model_best.pt")
        shutil.copyfile(path, best + ".tmp")
        os.replace(best + ".tmp", best)
        if extra is not None:
            shutil.copyfile(path + ".json", best + ".json.tmp")
            os.replace(best + ".json.tmp", best + ".json")
    return path


def load_checkpoint(state: TrainState, path: str) -> tuple[TrainState, dict]:
    """Restore the model, optimizer, schedule and step of `state` in place
    from `path` (tensors land on the model's device); returns (state, the
    metadata dict, empty when there is none)."""
    saved = torch.load(path, map_location=state.device, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.tx.optimizer.load_state_dict(saved["optimizer"])
    state.tx.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta
