"""Shared inputs for the tests that hold morig_tpu_torch against morig_tpu.

Small capsule fixture (n_lat=7, n_lon=6: V=38 padded to 128, degree-12
tables, P=128 points, T=5 keyframes).  P and V are multiples of 128 so the
JAX fused kNN and gather kernels run (in Pallas interpret mode) instead of
their XLA fallbacks.  Weights: every flax parameter, heads included, is
filled from a numpy seed at a trained net's scale and bridged to torch
through morig_tpu_torch.weights.  `jax_fused_kernels` routes the JAX side
through its Pallas kernels in interpret mode, at the port's precision.
"""
from __future__ import annotations

import contextlib
import functools
from collections.abc import Mapping

import jax
import numpy as np
import torch

from morig_tpu.core import batch as JB
from morig_tpu.kernels import edge_fused as jef
from morig_tpu.kernels import gather_fused as jgf
from morig_tpu.kernels import knn_fused as jkf
from morig_tpu.nn import gcu as jgcu
from morig_tpu_torch.core import batch as TB
from morig_tpu_torch.data.synthetic import capsule_batch

T, P, V_PAD, DEGREE = 5, 128, 128, 12
TIGHT = 5e-4        # fp32 on both sides; see test_torch_modules for the reasons

# The test workers share the machine's cores; torch's default of one
# intra-op thread per core makes its spinning threads fight the other
# workers (a 0.7 s port forward then takes ~40 s).  The shapes here are tiny.
torch.set_num_threads(1)


def capsule_inputs(B: int = 2, seed: int = 0):
    """B mesh entries (numpy dicts) and their (T, P, 3) keyframe clouds."""
    return capsule_batch(B, T, P, V_PAD, DEGREE, n_lat=7, n_lon=6, seed=seed)


def meshes(entries):
    """The same entries as a JAX MeshBatch and a torch MeshBatch."""
    return JB.stack_meshes(entries), TB.stack_meshes(entries)


def random_params(tree, seed: int):
    """numpy values for a flax params shape tree, by leaf name: kernels
    N(0, 1/fan_in), biases 0.1*N(0, 1), LayerNorm scales U(0.5, 1.5),
    cls_token N(0, 1), temperature 0.07."""
    rng = np.random.default_rng(seed)

    def fill(name, leaf):
        if isinstance(leaf, Mapping):
            return {k: fill(k, v) for k, v in leaf.items()}
        shape = tuple(leaf.shape)
        if name == "temperature":
            return np.float32(0.07)
        if name == "cls_token":
            return rng.standard_normal(shape).astype(np.float32)
        if name.endswith("kernel"):
            return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        if name.endswith("scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {k: fill(k, v) for k, v in tree.items()}


def flax_params(model, seed: int, *args, **kwargs):
    """Seeded numpy params for `model`, shaped by tracing its init abstractly."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *args, **kwargs))
    return random_params(dict(shapes["params"]), seed)


def bridged(net_cls, state_dict):
    net = net_cls()
    net.load_state_dict(state_dict, strict=True)
    return net.eval()


@contextlib.contextmanager
def jax_fused_kernels():
    """Route the JAX package through its Pallas kernels, in interpret mode on
    the CPU, as the port routes through its own: the kNN and row gather
    (bf16 similarity), and every EdgeMLP tail through the fused edge kernel
    (fp32 LayerNorms, bf16 W2 product), which flax's CPU path would
    otherwise run with bf16 LayerNorms.  The edge kernel is chosen by
    `gcu._fusable`, which declines on a CPU backend, and called without
    `interpret`; both are patched here and restored on exit, with the
    previous kNN and gather modes."""
    knn_mode, gather_mode = jkf.get_knn_impl(), jgf.get_gather_impl()
    fusable, edge_auto = jgcu._fusable, jef.fused_edge_mlp_auto
    jkf.set_knn_impl("fused")
    jgf.set_gather_impl("fused")
    jgcu._fusable = lambda channels, *_, **__: len(channels) == 2
    jef.fused_edge_mlp_auto = functools.partial(edge_auto, interpret=True)
    try:
        yield
    finally:
        jkf.set_knn_impl(knn_mode)
        jgf.set_gather_impl(gather_mode)
        jgcu._fusable, jef.fused_edge_mlp_auto = fusable, edge_auto


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, ref, atol: float, rtol: float = 0.0, what: str = ""):
    got, ref = np_(got).astype(np.float64), np_(ref).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    lim = atol + rtol * np.abs(ref)
    worst = float((err - lim).max()) if err.size else 0.0
    assert worst <= 0.0, f"{what}: max abs err {err.max():.3g} over tolerance"


# Relative tolerances (mean |err| / mean |ref|, max |err| / max |ref|) for
# outputs behind GCU edge layers.  Both sides run the same precision (bf16
# Dense inputs to the edge tail, bf16 W2 product, fp32 LayerNorms and
# accumulation, the JAX side through its Pallas edge kernel), so the only
# difference is fp32 summation order, except where it moves a value across
# a bf16 rounding boundary: that element then differs by one bf16 ulp
# (2^-8 relative) and the difference spreads through the layers after it.
#   LAYER: one edge-layer module (GCU, GCUMotion, a shape code) or one MLP
#     stack fed the reference's input.  Measured: mean <= 5e-6, max <= 4e-4.
#   NETWORK: a whole network or device program, through 4-12 edge layers
#     and a global max.  Measured: mean <= 9.5e-3, max <= 2.5e-2 (the
#     JointNet head; its trunk's outputs stay below 1e-3 and 4.1e-3).  The
#     mesh encoder (four GCUs, two MLP stacks, a global max) is a network:
#     its end-to-end mean error measured 1.011e-4 (max 1.58e-4) on one CPU,
#     just over the LAYER mean bound, while each GCU fed the reference's
#     input stays at <= 1.4e-6 mean.
LAYER = (1e-4, 5e-3)
NETWORK = (2e-2, 5e-2)


def assert_rel_close(got, ref, tol, mask=None, what=""):
    """mean |err| <= tol[0] * mean |ref| and max |err| <= tol[1] * max |ref|
    over the entries `mask` selects; `got` finite."""
    got, ref = np_(got).astype(np.float64), np_(ref).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if mask is not None:
        got, ref = got[mask], ref[mask]
    err = np.abs(got - ref)
    assert np.isfinite(got).all(), what
    assert err.mean() <= tol[0] * np.abs(ref).mean(), (what, err.mean(), np.abs(ref).mean())
    assert err.max() <= tol[1] * np.abs(ref).max(), (what, err.max(), np.abs(ref).max())
