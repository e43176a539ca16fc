"""Masked batch normalization ("batch" norm mode) — counterpart of
morig_tpu/nn/norm.py.

The reference puts a `BatchNorm1d` in every MLP stage, its statistics
taken over all vertices or points of the batch.  Under padding the
statistics must cover the valid elements only, so they are mask-weighted;
running statistics follow torch's momentum rule, new = (1 - m) old + m
batch, with the unbiased variance.  The parameter and buffer names are
torch's (and the reference's): `weight`, `bias`, `running_mean`,
`running_var`.

On a mesh (parallel/mesh.py, the JAX module's `axis_name`) the masked
count, the sum and the centred square sum are summed over the data group,
the last two differentiably (`data_sum`), so the statistics and the
running statistics are those of the global batch on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from morig_tpu_torch.parallel import batch_sum, data_sum


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis of x, statistics over the valid
    elements.  `forward(x, mask, train)`: with `train` the fp32 two-pass
    masked moments of this batch normalize x and update the running
    statistics; without, the running statistics normalize it.  `train` is
    the caller's argument, never `self.training`."""

    def __init__(self, n: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """`mask` is None or a bool/float array over a prefix of x's axes.
        The count is Σ mask as the JAX module takes it (each mask entry
        once), at least 1.  Statistics are E[x] then E[(x - mean)^2], never
        E[x^2] - mean^2, which cancels catastrophically in fp32 for
        channels of small variance."""
        C = x.shape[-1]
        xf = x.float()
        if train:
            if mask is None:
                m = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
            else:
                m = mask.float()
                while m.dim() < x.dim():
                    m = m[..., None]
            cnt = torch.clamp(batch_sum(m.sum()), min=1.0)
            mean = data_sum((xf * m).reshape(-1, C).sum(0)) / cnt
            centered = (xf - mean) * m
            var = data_sum((centered * centered).reshape(-1, C).sum(0)) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                mom = self.momentum
                self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(x.dtype)
