"""Gradient-descent inverse kinematics on the device — counterpart of
morig_tpu/geometry/ik.py.

Per-joint euler rotations and a root translation, packed as theta (J+1, 3)
= [rotation rows | translation row], are fitted with Adam so that the
LBS-posed constrained vertices meet their targets.  The optimizer is the
JAX package's fused grouped-lr Adam: the gradient from
`torch.autograd.grad` of the objective, weight decay added to it,
(b1, b2, eps) = (0.9, 0.999, 1e-8), bias correction with t = i + 1 in fp32,
lr * pi on the rotation rows and lr on the translation row.  The loop runs
a fixed number of iterations with no host synchronization inside it (no
`.item()`, no branch on a tensor).

Constraints are shape-static: `constraint_idx` picks the vertex each
constraint binds to and `vismask` / `valid` weight it, so masked rows count
nothing.  `make_ik_solver` solves one rig on an `FKTopology`;
`make_ik_solver_masked` solves a batch of rigs with different trees on
their array topologies (`fk_masked_doubling`) at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from morig_tpu_torch.geometry.fk import FKTopology, fk, fk_masked_doubling, lbs_blend
from morig_tpu_torch.geometry.rotations import euler_to_matrix

_B1, _B2, _EPS = 0.9, 0.999, 1e-8       # optax.adam's defaults


@dataclasses.dataclass
class IKConfig:
    """The JAX IKConfig's fields but `unroll`, which tunes an XLA loop."""

    iters: int = 200
    lr: float = 5e-2
    weight_decay: float = 1e-4
    vismask_threshold: float = 0.35
    w_invis: float = 0.0
    init_angle: float = 0.01


@contextlib.contextmanager
def highest_precision():
    """fp32 products at full precision (no TF32) inside, the previous
    setting restored on exit: 600 Adam steps amplify TF32's rounding of the
    LBS product."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _bias_corrections(iters: int) -> list:
    """(1 - b1^t, 1 - b2^t) for t = 1..iters, computed in fp32."""
    t = np.arange(1, iters + 1, dtype=np.float32)
    return list(zip((np.float32(1) - np.float32(_B1) ** t).tolist(),
                    (np.float32(1) - np.float32(_B2) ** t).tolist()))


def _run_adam(objective, theta0: torch.Tensor, lr_row: torch.Tensor, cfg: IKConfig):
    """Minimize objective(theta) (a scalar; summed over a batch of
    independent problems) from theta0 (..., J+1, 3) with the grouped-lr
    Adam; lr_row (J+1, 1) holds each row's learning rate."""
    theta, m, v = theta0, torch.zeros_like(theta0), torch.zeros_like(theta0)
    for c1, c2 in _bias_corrections(cfg.iters):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            g, = torch.autograd.grad(objective(th), th)
        g = g + cfg.weight_decay * theta
        m = _B1 * m + (1.0 - _B1) * g
        v = _B2 * v + (1.0 - _B2) * g * g
        theta = theta - lr_row * ((m / c1) / (torch.sqrt(v / c2) + _EPS))
    return theta


def _lr_row(J: int, cfg: IKConfig, device) -> torch.Tensor:
    lr = torch.full((J + 1, 1), cfg.lr * math.pi, dtype=torch.float32, device=device)
    lr[J] = cfg.lr
    return lr


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., V, C) rows at idx (..., N) -> (..., N, C)."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def make_ik_solver(topology: FKTopology, cfg: IKConfig):
    """An IK solve for one rig topology:

    solve(locals_in (J,3,3), offsets (J,3), ref_G (J,3,3), ref_q (J,3),
          ref_verts (V,3), skins (V,J), constraint_idx (N,) int,
          targets (N,3), vismask (N,)) -> (locals_out, G, q)

    ref_G / ref_q / ref_verts are the pose the vertices are bound in.  The
    loss is the mean over the N constraints and 3 coordinates of the
    visibility-weighted squared error."""
    J = topology.num_joints

    @torch.no_grad()
    def solve(locals_in, offsets, ref_G, ref_q, ref_verts, skins, constraint_idx, targets,
              vismask):
        w = torch.where(vismask > cfg.vismask_threshold, 1.0, cfg.w_invis)
        v_c = _gather_rows(ref_verts, constraint_idx)
        sk_c = _gather_rows(skins, constraint_idx)

        def objective(theta):
            G, q = fk(topology, euler_to_matrix(theta[:J]) @ locals_in, offsets, theta[J])
            err = ((lbs_blend(G, q, ref_G, ref_q, v_c, sk_c) - targets) ** 2).sum(-1)
            return (err * w).mean() / 3.0

        theta0 = torch.full((J + 1, 3), cfg.init_angle, dtype=torch.float32,
                            device=locals_in.device)
        theta = _run_adam(objective, theta0, _lr_row(J, cfg, locals_in.device), cfg)
        locals_out = euler_to_matrix(theta[:J]) @ locals_in
        G, q = fk(topology, locals_out, offsets, theta[J])
        return locals_out, G, q

    return solve


def make_ik_solver_masked(max_depth: int, cfg: IKConfig):
    """An IK solve over a batch of rigs on their array topologies (the
    port's form of the JAX solver vmapped over rigs): every argument has a
    leading batch axis B.

    solve(locals_in (B,J,3,3), offsets (B,J,3), parents (B,J), level_of
          (B,J), ref_G (B,J,3,3), ref_q (B,J,3), ref_verts (B,V,3), skins
          (B,V,J), constraint_idx (B,N), targets (B,N,3), vismask (B,N),
          valid (B,N)) -> (locals_out, G, q)

    Each rig's loss is its weighted squared error summed over the
    constraints and divided by 3 x its count of valid ones; the rigs are
    independent, so one gradient of their sum serves all."""

    @torch.no_grad()
    def solve(locals_in, offsets, parents, level_of, ref_G, ref_q, ref_verts, skins,
              constraint_idx, targets, vismask, valid):
        J = locals_in.shape[-3]
        w = torch.where(vismask > cfg.vismask_threshold, 1.0, cfg.w_invis) * valid
        denom = 3.0 * torch.clamp(valid.sum(-1), min=1.0)
        v_c = _gather_rows(ref_verts, constraint_idx)
        sk_c = _gather_rows(skins, constraint_idx)

        def pose(theta, locals_):
            return fk_masked_doubling(parents, level_of, locals_, offsets, max_depth,
                                      theta[..., J, :])

        def objective(theta):
            G, q = pose(theta, euler_to_matrix(theta[..., :J, :]) @ locals_in)
            err = ((lbs_blend(G, q, ref_G, ref_q, v_c, sk_c) - targets) ** 2).sum(-1)
            return ((err * w).sum(-1) / denom).sum()

        theta0 = torch.full(locals_in.shape[:-3] + (J + 1, 3), cfg.init_angle,
                            dtype=torch.float32, device=locals_in.device)
        theta = _run_adam(objective, theta0, _lr_row(J, cfg, locals_in.device), cfg)
        locals_out = euler_to_matrix(theta[..., :J, :]) @ locals_in
        G, q = pose(theta, locals_out)
        return locals_out, G, q

    return solve
