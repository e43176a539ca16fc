"""Checkpoints of a TrainState in the port's own format — counterpart of
morig_tpu/train/checkpoint.py `save_checkpoint` / `load_checkpoint`.

A checkpoint is one `torch.save` file of the model's, the optimizer's and
the schedule's state dicts and the step count, written atomically (a
temporary file, then a rename), with the caller's metadata beside it as
JSON; `model_best.pt` is a copy made when validation improves.

`load_flax_checkpoint` reads the JAX package's checkpoints: the flax
msgpack files (`serialization.to_bytes` of {step, params, batch_stats,
opt_state}) that morig_tpu/train/checkpoint.py writes.  Its msgpack
decoder is written here in Python and numpy, since the `msgpack` package
is not a dependency of the port: the types flax writes (maps, arrays,
str, bin, ints, floats, nil, bool), its ext types 1 (an ndarray: a
msgpack (shape, dtype name, C-order bytes)) and 3 (a numpy scalar, packed
as an ndarray), and the chunked leaves it writes above its MAX_CHUNK_SIZE.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Optional

import numpy as np
import torch

from morig_tpu_torch.train.trainer import TrainState


def _state_dict(state: TrainState, model_state: Optional[dict] = None) -> dict:
    return {"step": state.step,
            "model": state.model.state_dict() if model_state is None else model_state,
            "optimizer": state.tx.optimizer.state_dict(),
            "scheduler": state.tx.scheduler.state_dict()}


def save_checkpoint(state: TrainState, checkpoint_dir: str, is_best: bool = False,
                    extra: Optional[dict] = None, filename: str = "checkpoint.pt",
                    model_state: Optional[dict] = None) -> str:
    """Write `checkpoint_dir/filename` (and `.json` metadata from `extra`);
    with is_best, copy both to `model_best.pt`.  `model_state`: the model's
    state dict to write in place of the model's own (the scanned runner's
    best-on-val weights beside the state's optimizer).  Returns the path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, filename)
    torch.save(_state_dict(state, model_state), path + ".tmp")
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
    state.tx.conform()
    state.step = int(saved["step"])
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta


# ---------------------------------------------------------------------------
# flax msgpack checkpoints
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
           "float16", "float32", "float64")
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer for the subset flax writes."""

    _FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
              0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    _LEN = {1: ">B", 2: ">H", 4: ">I"}

    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, nbytes: int) -> int:
        return self.unpack(self._LEN[nbytes])

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in self._FIXED:
            return self.unpack(self._FIXED[b])
        if 0xc4 <= b <= 0xc6:                                # bin 8/16/32
            return bytes(self.take(self.length(1 << (b - 0xc4))))
        if 0xd9 <= b <= 0xdb:                                # str 8/16/32
            return str(self.take(self.length(1 << (b - 0xd9))), "utf-8")
        if b in (0xdc, 0xdd):
            return self.array(self.length(2 if b == 0xdc else 4))
        if b in (0xde, 0xdf):
            return self.map(self.length(2 if b == 0xde else 4))
        if 0xc7 <= b <= 0xc9:                                # ext 8/16/32
            n = self.length(1 << (b - 0xc7))
            return self.ext(self.unpack(">b"), n)
        if 0xd4 <= b <= 0xd8:                                # fixext 1-16
            return self.ext(self.unpack(">b"), 1 << (b - 0xd4))
        raise ValueError(f"msgpack type byte {b:#x} is not one flax writes")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"msgpack ext type {code} is not an ndarray or numpy scalar")


def _ndarray(data: bytes):
    """flax's ndarray ext: msgpack (shape, dtype name, C-order bytes) ->
    a numpy array, or a torch.bfloat16 tensor for bfloat16."""
    shape, name, raw = _Reader(data).value()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) if raw else \
            torch.zeros(0, dtype=torch.bfloat16)
        return flat.reshape(shape)
    if name not in _DTYPES:
        raise ValueError(f"flax checkpoint leaf of dtype {name!r} is not supported")
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    """Replace flax's chunked leaves ({_CHUNKED, "shape", "chunks"}, dicts
    keyed "0", "1", ...) by the arrays they hold."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        cat = torch.cat if isinstance(chunks[0], torch.Tensor) else np.concatenate
        return cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_checkpoint(path: str) -> dict:
    """Read a flax msgpack checkpoint of the JAX package (train/checkpoint.py
    `save_checkpoint`) without JAX: {"step": int, "params": nested dict,
    "batch_stats": nested dict, "opt_state": nested dict}, leaves numpy
    arrays (torch.bfloat16 tensors for bfloat16 leaves).  `params` feeds
    `weights.flax_to_state_dict`, or `RigPredictor.from_flax_params` per
    network.  Raises on a type, ext code or dtype flax does not write."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: {len(reader.buf) - reader.pos} bytes after the checkpoint")
    if not isinstance(tree, dict) or not {"step", "params"} <= set(tree):
        raise ValueError(f"{path} is not a flax train-state checkpoint")
    tree = _unchunk(tree)
    return {"step": int(tree["step"]), "params": tree["params"],
            "batch_stats": tree.get("batch_stats") or {},
            "opt_state": tree.get("opt_state")}
