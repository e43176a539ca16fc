"""The MLP block: Linear -> ReLU -> Norm per stage.  Counterpart of
morig_tpu/nn/mlp.py.

The norm is the process-wide mode of `set_default_norm`:
  * "layer" (the default): LayerNorm, stages dense_i -> relu -> ln_i;
  * "batch": `MaskedBatchNorm` (nn/norm.py), stages dense_i -> relu ->
    bn_i, the reference's numerics and the mode its trained weights load
    in (eval/torch_import.py);
  * "none": dense_i -> relu.
A module reads the mode when it is built and keeps it: its parameter tree
depends on the mode, so a module built in one mode never runs in another.

Initialization follows flax: lecun-normal kernels (truncated at two
standard deviations), zero biases, norm scales one and offsets zero, zero
heads where `zero_init`.  `init_parameters` walks a module tree and
re-initializes every parameter from one torch.Generator.

Precision: in "layer" mode MLP matmuls run in fp32 in training and at
inference in the dtype `set_inference_dtype` selects (the JAX package's
`infer_matmul_dtype`): "auto" (the default) bf16 on the GPU and fp32 on
the CPU, "bf16" everywhere, "f32" everywhere; LayerNorm statistics and
outputs are fp32 (eps 1e-6, flax's E[x^2] - E[x]^2 variance).  In "batch"
and "none" mode every matmul is fp32, on the GPU too.  The edge layers'
messages (nn/gcu.py) stay bf16 at inference whatever the setting, as the
JAX package's `edge_dtype` does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from morig_tpu_torch.kernels.edge_fused import layer_norm
from morig_tpu_torch.nn.norm import MaskedBatchNorm

NORMS = ("layer", "batch", "none")
_DEFAULT_NORM = "layer"
INFERENCE_DTYPES = ("auto", "bf16", "f32")
_INFER_DTYPE = "auto"
_TRUNC_STD = 0.87962566103423978   # std of a standard normal truncated at +-2


def set_default_norm(name: str) -> None:
    """Set the process-wide norm mode ("layer" | "batch" | "none") of the
    modules built after the call."""
    global _DEFAULT_NORM
    if name not in NORMS:
        raise ValueError(f"norm must be one of {NORMS}, got {name!r}")
    _DEFAULT_NORM = name


def get_default_norm() -> str:
    return _DEFAULT_NORM


def set_inference_dtype(name: str) -> None:
    """Set the process-wide matmul precision of the "layer"-mode MLP layers
    at inference: "auto" (bf16 on the GPU, fp32 on the CPU), "bf16" or
    "f32".  Read at every call; training and the other norm modes compute
    in fp32 whatever it says."""
    global _INFER_DTYPE
    if name not in INFERENCE_DTYPES:
        raise ValueError(f"inference dtype must be one of {INFERENCE_DTYPES}, got {name!r}")
    _INFER_DTYPE = name


def get_inference_dtype() -> str:
    return _INFER_DTYPE


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every parameter of `module` in a fixed module order."""
    with torch.no_grad():
        for m in module.modules():
            reset = getattr(m, "reset_parameters", None)
            if reset is not None:
                reset(generator)


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def matmul_dtype(x: torch.Tensor, train: bool = False) -> torch.dtype:
    """Matmul dtype of the "layer"-mode MLP layers: fp32 in training; at
    inference as `set_inference_dtype` says ("auto": bf16 on the GPU, fp32
    on the CPU).  The other modes compute in fp32 (`MLP.compute_dtype`)."""
    if train or _INFER_DTYPE == "f32":
        return torch.float32
    if _INFER_DTYPE == "bf16":
        return torch.bfloat16
    return torch.bfloat16 if x.is_cuda else torch.float32


class Dense(nn.Module):
    """flax nn.Dense: y = x @ W^T + b, computed in `dtype` (inputs, weight and
    bias rounded to it, output in it); fp32 when dtype is None."""

    def __init__(self, fin: int, fout: int, bias: bool = True, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.zero_init:
            self.weight.zero_()
        else:
            lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or torch.float32
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y + self.bias.to(dt) if self.bias is not None else y


class LayerNorm(nn.Module):
    """fp32 LayerNorm over the last axis with flax's statistics (eps 1e-6)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class MLP(nn.Module):
    """Stages dense_i -> relu -> ln_i ("layer"), -> bn_i ("batch") or no
    norm ("none"), in the mode current when it is built; returns fp32.
    `mask` (a prefix of x's axes) selects the elements of the batch
    statistics in "batch" mode; the other modes ignore it."""

    def __init__(self, fin: int, channels: Sequence[int]):
        super().__init__()
        self.channels = list(channels)
        self.norm = get_default_norm()
        dims = [fin] + self.channels
        for i, ch in enumerate(self.channels):
            self.add_module(f"dense_{i}", Dense(dims[i], ch))
            if self.norm == "layer":
                self.add_module(f"ln_{i}", LayerNorm(ch))
            elif self.norm == "batch":
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch))

    def compute_dtype(self, x: torch.Tensor, train: bool) -> torch.dtype:
        """The matmul dtype: `matmul_dtype` in "layer" mode, else fp32."""
        return matmul_dtype(x, train) if self.norm == "layer" else torch.float32

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        dt = self.compute_dtype(x, train)
        for i in range(len(self.channels)):
            x = torch.relu(getattr(self, f"dense_{i}")(x, dt))
            if self.norm == "layer":
                x = getattr(self, f"ln_{i}")(x)
            elif self.norm == "batch":
                x = getattr(self, f"bn_{i}")(x, mask, train)
        return x.float()


class MLPHead(nn.Module):
    """MLP followed by a plain Linear `out` (zero-initialized with zero_init)."""

    def __init__(self, fin: int, channels: Sequence[int], out: int, zero_init: bool = False):
        super().__init__()
        self.mlp = MLP(fin, channels)
        self.out = Dense(channels[-1], out, zero_init=zero_init)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        h = self.mlp(x, mask, train)
        return self.out(h, self.mlp.compute_dtype(h, train)).float()
