"""The data x model mesh of a torch.distributed world, and what the port's
modules compute on it: the collectives that XLA inserts for the JAX
package's placements (morig_tpu/parallel/sharding.py), written by hand.

In JAX placement never changes what a step computes.  Here each rank
computes on its own rows, so every reduction over the batch is made global
by hand, under one convention:

  * rank r's loss is its own contribution to the global loss: the global
    loss is the sum over the data group, and the gradients are summed over
    the data group (`TrainState.apply_gradients`);
  * a masked mean sum(num) / sum(den) is local sum(num) / `batch_sum`(sum(den))
    (the denominator is a count and takes no gradient);
  * a mean over the batch is `batch_mean`: local sum / global element count;
  * the metrics a step reports are summed over the data group;
  * a random draw is made at the global shape by every rank from a
    generator in the same state, and each rank keeps its rows (`rand`), so
    the generators stay in lockstep and the draw equals the one-device one;
  * "batch" norm statistics are summed over the data group by `data_sum`,
    whose backward sums the upstream gradients over the group too.

The mesh a step runs on is set by `active(mesh)` around its forward and
losses (the stages' `train_step(..., mesh=)`); without one every helper is
the identity and the step is the one-device step, bit for bit.

A tensor-parallel `Dense` (its output rows sharded over the model group by
`sharding.shard_state`) runs `tp_linear`: the input through `_ToModel`
(identity forward; backward sums dx over the model group), the local
product, then `_FromModel` (forward: the slices gathered into the full
output in rank order; backward: the rank's own slice of dy, not summed,
since every model rank computes the same loss).  The gather is an
all-reduce of a zero-filled full-width fp32 buffer into which each rank
copies its slice: adding zeros is exact, and NCCL and gloo both take
all_reduce on CUDA tensors, so one card can run several ranks over gloo.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A rank's place on a data x model mesh: `data_index` (which rows of
    the batch it holds) and `model_index` (which slice of each sharded
    layer), with its two subgroups: `data_group`, the ranks that share its
    model_index, and `model_group`, the ranks that share its data_index."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor over the global batch (axis 0)."""
        n = x.shape[0] // self.data
        return x[self.data_index * n:(self.data_index + 1) * n]


_CURRENT: Optional[DeviceMesh] = None


@contextlib.contextmanager
def active(mesh: Optional[DeviceMesh]):
    """Run the block on `mesh` (None: one device)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, mesh
    try:
        yield mesh
    finally:
        _CURRENT = prev


def current() -> Optional[DeviceMesh]:
    return _CURRENT


def _data_mesh() -> Optional[DeviceMesh]:
    """The active mesh where its data group has more than one rank."""
    return _CURRENT if _CURRENT is not None and _CURRENT.data > 1 else None


def all_reduce_(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Sum x in place over `group` (of `size` ranks; nothing to do at 1)."""
    if size > 1:
        dist.all_reduce(x, group=group)
    return x


class _SumOver(torch.autograd.Function):
    """y = the sum of x over a group; dx = the sum of dy over the group."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return all_reduce_(x.clone(), group, size)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(), ctx.group, ctx.size), None, None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active mesh's data group, differentiably; x
    itself without one."""
    mesh = _data_mesh()
    return x if mesh is None else _SumOver.apply(x, mesh.data_group, mesh.data)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A count over this rank's rows (a masked mean's denominator) summed
    over the active mesh's data group, without gradient; x itself without
    one."""
    mesh = _data_mesh()
    if mesh is None:
        return x
    return all_reduce_(x.detach().clone(), mesh.data_group, mesh.data)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over all elements of a tensor whose axis 0 is the batch:
    x.mean() without a mesh, this rank's share of the global mean (local
    sum / global element count) on one."""
    mesh = _data_mesh()
    return x.mean() if mesh is None else x.sum() / (x.numel() * mesh.data)


def rand(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """torch.rand(shape) with axis 0 the batch: on a mesh drawn at the
    global batch (every rank alike), this rank's rows kept."""
    mesh = _data_mesh()
    if mesh is None:
        return torch.rand(shape, generator=generator, device=device)
    full = (shape[0] * mesh.data,) + tuple(shape[1:])
    return mesh.rows(torch.rand(full, generator=generator, device=device))


def gather_model(y: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The model group's slices of the last axis, this rank's `y` among
    them, as one tensor in rank order (no gradient)."""
    n = y.shape[-1]
    full = torch.zeros(y.shape[:-1] + (n * mesh.model,), dtype=torch.float32, device=y.device)
    full[..., mesh.model_index * n:(mesh.model_index + 1) * n] = y
    return all_reduce_(full, mesh.model_group, mesh.model).to(y.dtype)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return all_reduce_(dx.clone(), ctx.mesh.model_group, ctx.mesh.model), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.n = mesh, y.shape[-1]
        return gather_model(y, mesh)

    @staticmethod
    def backward(ctx, dy):
        i, n = ctx.mesh.model_index, ctx.n
        return dy[..., i * n:(i + 1) * n].contiguous(), None


def tp_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: torch.dtype, mesh: DeviceMesh) -> torch.Tensor:
    """nn.mlp.Dense's x @ W^T + b in `dtype` with W's output rows (and b)
    sharded over mesh's model group: the full output on every rank."""
    x = _ToModel.apply(x, mesh)
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    if bias is not None:
        y = y + bias.to(dtype)
    return _FromModel.apply(y, mesh)
