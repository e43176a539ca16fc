"""Weights of the port's networks: the bridge from flax parameter trees, and
seeded random weights at a trained network's scale.

The port's module tree mirrors the flax tree name for name, in every norm
mode, so the map is structural:

  * a Dense `{kernel (in, out), bias}` becomes `weight` (out, in) + `bias`;
  * a LayerNorm or MaskedBatchNorm `{scale, bias}` becomes `weight` +
    `bias`, and a MaskedBatchNorm's `batch_stats` `{mean, var}`
    `running_mean` + `running_var` ("batch" mode);
  * EdgeMLP's explicit tail parameters (`dense_1_kernel` (in, out),
    `dense_1_bias`, `ln0_*`, `ln1_*`), the TemporalAttn `cls_token` and the
    CorrNet `temperature` keep their names and layouts.

EdgeMLP's `lin_self` already carries (W1 - W2) with the bias and `lin_nbr`
W2 without one, on both sides, so no re-parameterization happens here (it
is the reverse of morig_tpu/eval/torch_import.py, which splits the
reference's concatenated first layer).  Inputs are nested dicts of numpy
arrays (`jax.device_get` of a flax `params` tree); outputs load with
`load_state_dict(strict=True)`.  One function serves all six networks of
the rig DAG (DeformNet, JointNetMotion, MaskNetMotion, SkinMotion, BoneNet,
RootNet).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):                        # a bfloat16 checkpoint leaf
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def flax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None,
                       prefix: str = "") -> dict[str, torch.Tensor]:
    """The state dict of a flax `params` tree and, in "batch" norm mode, its
    `batch_stats` tree."""
    out: dict[str, torch.Tensor] = {}
    if batch_stats:
        out.update(_stats_to_state_dict(batch_stats, prefix))
    for name, val in params.items():
        path = f"{prefix}{name}"
        if not isinstance(val, Mapping):
            out[path] = _tensor(val)
        elif "kernel" in val:                              # Dense
            out[f"{path}.weight"] = _tensor(np.asarray(val["kernel"]).T)
            if "bias" in val:
                out[f"{path}.bias"] = _tensor(val["bias"])
        elif set(val) == {"scale", "bias"}:                # LayerNorm
            out[f"{path}.weight"] = _tensor(val["scale"])
            out[f"{path}.bias"] = _tensor(val["bias"])
        else:
            out.update(flax_to_state_dict(val, prefix=f"{path}."))
    return out


def _stats_to_state_dict(stats: Mapping, prefix: str) -> dict[str, torch.Tensor]:
    if set(stats) == {"mean", "var"}:
        return {f"{prefix}running_mean": _tensor(stats["mean"]),
                f"{prefix}running_var": _tensor(stats["var"])}
    out: dict[str, torch.Tensor] = {}
    for name, val in stats.items():
        out.update(_stats_to_state_dict(val, f"{prefix}{name}."))
    return out


def randomize_(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter, zero-initialized heads included, with seeded
    values of a trained network's scale: kernels N(0, 1/fan_in), biases
    0.1*N(0, 1), LayerNorm and BatchNorm scales U(0.5, 1.5), cls_token
    N(0, 1); CorrNet's temperature keeps its value.  Fresh heads are zero,
    which makes the flow exactly 0 and leaves most of the DAG untested.
    Then the BatchNorm buffers ("batch" mode): running means N(0, 0.5),
    running variances U(0.5, 2), without which an eval-mode forward would
    not test the statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "temperature":
                continue
            if leaf == "cls_token":
                p.copy_(torch.randn(p.shape, generator=g))
            elif leaf == "dense_1_kernel":                   # (in, out)
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[0]))
            elif leaf == "weight" and p.dim() == 2:          # (out, in)
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1]))
            elif leaf == "weight" or leaf.endswith("_scale"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for name, b in net.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.5 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) * 1.5 + 0.5)
    return net
