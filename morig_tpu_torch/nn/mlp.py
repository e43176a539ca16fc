"""The MLP block: Linear -> ReLU -> LayerNorm per stage ("layer" norm mode).

Counterpart of morig_tpu/nn/mlp.py.  Initialization follows flax: lecun-
normal kernels (truncated at two standard deviations), zero biases, LN
ones and zeros, zero heads where `zero_init`.  `init_parameters` walks a
module tree and re-initializes every parameter from one torch.Generator.

Precision: MLP matmuls run in bf16 on the GPU and fp32 on the CPU (the JAX
package's `infer_matmul_dtype` in "layer" mode); LayerNorm statistics and
outputs are fp32 (eps 1e-6, flax's E[x^2] - E[x]^2 variance).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from morig_tpu_torch.kernels.edge_fused import layer_norm

_TRUNC_STD = 0.87962566103423978   # std of a standard normal truncated at +-2


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


def matmul_dtype(x: torch.Tensor) -> torch.dtype:
    """Inference matmul dtype of the MLP layers: bf16 on the GPU, fp32 on CPU."""
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
    """Stages dense_i -> relu -> ln_i; returns fp32."""

    def __init__(self, fin: int, channels: Sequence[int]):
        super().__init__()
        self.channels = list(channels)
        dims = [fin] + self.channels
        for i, ch in enumerate(self.channels):
            self.add_module(f"dense_{i}", Dense(dims[i], ch))
            self.add_module(f"ln_{i}", LayerNorm(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = matmul_dtype(x)
        for i in range(len(self.channels)):
            x = torch.relu(getattr(self, f"dense_{i}")(x, dt))
            x = getattr(self, f"ln_{i}")(x)
        return x.float()


class MLPHead(nn.Module):
    """MLP followed by a plain Linear `out` (zero-initialized with zero_init)."""

    def __init__(self, fin: int, channels: Sequence[int], out: int, zero_init: bool = False):
        super().__init__()
        self.mlp = MLP(fin, channels)
        self.out = Dense(channels[-1], out, zero_init=zero_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mlp(x)
        return self.out(h, matmul_dtype(h)).float()
