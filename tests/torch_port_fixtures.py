"""Shared inputs for the tests that hold morig_tpu_torch against morig_tpu.

Small capsule fixture (n_lat=7, n_lon=6: V=38 padded to 128, degree-12
tables, P=128 points, T=5 keyframes).  P and V are multiples of 128 so the
JAX fused kNN and gather kernels run (in Pallas interpret mode) instead of
their XLA fallbacks.  Weights: every flax parameter, heads included, is
filled from a numpy seed at a trained net's scale and bridged to torch
through morig_tpu_torch.weights.  `jax_fused_kernels` routes the JAX side
through its Pallas kernels in interpret mode, at the port's precision, and
`jax_training_kernels` does the same for its training path.
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
    """The same entries as a JAX MeshBatch and a torch MeshBatch (CPU)."""
    return JB.stack_meshes(entries), TB.stack_meshes(entries, device="cpu")


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


def random_stats(tree, seed: int):
    """numpy values for a flax batch_stats shape tree: means N(0, 0.5),
    variances U(0.5, 2), as tests/torch_oracle.py `randomize_bn_stats`."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if set(node) == {"mean", "var"}:
            shape = tuple(node["mean"].shape)
            return {"mean": (0.5 * rng.standard_normal(shape)).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, shape).astype(np.float32)}
        return {k: fill(v) for k, v in node.items()}

    return fill(dict(tree))


def flax_variables(model, seed: int, *args, **kwargs):
    """Seeded numpy (params, batch_stats) for a "batch"-norm-mode `model`."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *args, **kwargs))
    return (random_params(dict(shapes["params"]), seed),
            random_stats(shapes["batch_stats"], seed + 1))


@contextlib.contextmanager
def norm_mode(name: str):
    """Both packages' process-wide norm mode set to `name`, each restored on
    exit.  Port modules read the mode when built, flax modules when called:
    build and call both inside."""
    from morig_tpu.nn import mlp as jmlp
    from morig_tpu_torch.nn import mlp as tmlp

    prev = jmlp.get_default_norm(), tmlp.get_default_norm()
    jmlp.set_default_norm(name)
    tmlp.set_default_norm(name)
    try:
        yield
    finally:
        jmlp.set_default_norm(prev[0])
        tmlp.set_default_norm(prev[1])


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


@contextlib.contextmanager
def jax_training_kernels():
    """Route the JAX package's training path through its Pallas kernels, in
    interpret mode on the CPU, as the port trains: every EdgeMLP tail through
    the fused forward and the fused backward kernel (set_edge_impl("fused"),
    set_edge_bwd("pallas")), and the kNN through the fused kernel with its
    VJP.  Three gates are patched: `gcu._fusable` (declines a CPU backend and
    widths below 128), `gcu._vmem_tile_bwd` (its TPU scoped-VMEM budget
    rejects H=256 at D=12, where the JAX side would silently take the
    remat-XLA backward; it returns 128 here) and
    `edge_fused.fused_edge_mlp_trainable` (gcu.py passes interpret=False
    positionally; forced to True here).  The row gather keeps its default,
    the exact XLA gather in training, as the port's.  Every setting is
    restored on exit."""
    knn_mode, impl, bwd = jkf.get_knn_impl(), jgcu.get_edge_impl(), jgcu.get_edge_bwd()
    fusable, tile_bwd = jgcu._fusable, jgcu._vmem_tile_bwd
    trainable = jef.fused_edge_mlp_trainable
    jkf.set_knn_impl("fused")
    jgcu.set_edge_impl("fused")
    jgcu.set_edge_bwd("pallas")
    jgcu._fusable = lambda channels, *_, **__: len(channels) == 2
    jgcu._vmem_tile_bwd = lambda *_, **__: 128
    # (a, ..., be2, windowed, interpret, pallas_bwd, bwd_tile_v)
    jef.fused_edge_mlp_trainable = lambda *args: trainable(*args[:11], True, *args[12:])
    try:
        yield
    finally:
        jkf.set_knn_impl(knn_mode)
        jgcu.set_edge_impl(impl)
        jgcu.set_edge_bwd(bwd)
        jgcu._fusable, jgcu._vmem_tile_bwd = fusable, tile_bwd
        jef.fused_edge_mlp_trainable = trainable


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
# GRAD: one parameter's gradient after a training step's backward through
# the mesh encoder's 8 edge layers (bf16 products with fp32 sums in K6).
# Each side rounds ds, dh and dx to bf16 at its own points, and the two
# forwards already differ at NETWORK level; the backward amplifies both.
# Measured on the CorrNet step of test_torch_train: the JAX package's own
# fused backward and its fp32 remat backward, on one forward, differ by up
# to 0.19 (mean) and 0.29 (max) relative at the first edge layers; the port
# against JAX by up to 0.154 and 0.384, the max at `vtx_mlp_glb`, whose
# output feeds a max over vertices that routes each channel's gradient to
# one vertex.  The whole gradient vector agrees to 0.035 (relative L2).
# Held at about twice those, since other CPUs round elsewhere.  GRAD is the
# whole step's sanity check only: the backward is held tightly module by
# module (LAYER_GRAD, TIGHT_GRAD), each module fed the same input and dout.
GRAD = (0.3, 0.6)
GRAD_TOTAL = 8e-2
# STEP_GRAD: one parameter's gradient after a whole motion-stage step, whose
# backward runs through 12 (DeformNet, extractor frozen), 20 (extractor
# trained) or 36 (JointNet, MaskNet, SkinMotion at T=2) edge layers.  The
# bf16 rounding differences of GRAD's comment grow with the depth: measured
# on one CPU, the port against the JAX package's Pallas step by up to 0.52
# (mean) and 1.33 (max, a JointNet bias whose gradient the chamfer's min
# routes to a few vertices) relative, and the whole vector (STEP_GRAD_TOTAL)
# to 0.167 relative L2.  The JAX package's own two training paths (the fused
# Pallas backward and the fp32 XLA one) differ more on the same DeformNet
# step: 1.42 (mean), 2.49 (max), 0.71 (whole vector).  The mean bound stays
# below 1, which a missing gradient would reach; the modules are held tightly
# one by one (LAYER_GRAD, TIGHT_GRAD).
STEP_GRAD = (0.8, 2.5)
STEP_GRAD_TOTAL = 0.3
# With DeformNet's extractor trained, PointNet++'s gradient arrives through
# the per-sample min and max of the visibility (each routed to one vertex)
# and the kNN selections, which move with the last bits of the embeddings:
# the port and the Pallas step differ there by 0.78 relative L2 (the JAX
# package's two paths by 4.9), the whole vector by 0.443 (by 3.39).  Held
# at EXTRACTOR_GROUP_L2 for that group and EXTRACTOR_GRAD_TOTAL for the
# whole vector; every other parameter at STEP_GRAD.
EXTRACTOR_GROUP_L2 = 0.9
EXTRACTOR_GRAD_TOTAL = 0.6
# LAYER_GRAD: one GCU's output, input gradient and parameter gradients in
# training (two edge layers through K1 + K6, the JAX side through its Pallas
# kernels).  K6 rounds ds, dh and dx to bf16 from fp32 values that differ in
# the last bits between the sides (the LN variance as E[x^2] - mu^2 here, in
# two passes there), so a few elements land one bf16 ulp apart, more at the
# wider layers.  Measured: mean <= 1.3e-4, max <= 1.04e-3 (GCU(256, 512)).
LAYER_GRAD = (5e-4, 5e-3)
# TIGHT_GRAD: backward through fp32 modules (MLP stacks, PointNet++, the
# vismask head with K2's fp32 VJP, the losses).  Measured: mean <= 2.3e-5,
# max <= 4e-5.
TIGHT_GRAD = (1e-4, 1e-3)


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


def jax_multi_pos_draws(key, gt_skin, vert_mask, num_sample: int, num_pos: int = 10,
                        num_neg: int = 200, sim_threshold: float = 0.9):
    """The indices morig_tpu.losses.nce.multi_pos_info_nce draws from `key`:
    its per-sample key split and jax.random.choice calls, repeated line for
    line.  Returns numpy (ids (B,S), pos_ids (B,S,num_pos), neg_ids
    (B,S,num_neg)), which the port's `multi_pos_info_nce_drawn` takes."""
    import jax.numpy as jnp

    V = vert_mask.shape[1]

    def per_sample(key, skin, mask):
        k1, k2, k3 = jax.random.split(key, 3)
        p = mask.astype(jnp.float32)
        p = p / jnp.maximum(p.sum(), 1.0)
        ids = jax.random.choice(k1, V, (num_sample,), replace=False, p=p)
        row_ok = mask[ids]
        s = skin[ids]
        gt_sim = (2.0 - jnp.sum(jnp.abs(s[None] - s[:, None]), axis=-1)) / 2.0
        pos_mat = (gt_sim > sim_threshold).astype(jnp.float32)
        neg_mat = (1.0 - pos_mat) * row_ok[None, :].astype(jnp.float32)
        pos_mat = pos_mat * row_ok[None, :].astype(jnp.float32)
        pos_p = pos_mat / jnp.maximum(pos_mat.sum(-1, keepdims=True), 1e-9)
        neg_p = neg_mat / jnp.maximum(neg_mat.sum(-1, keepdims=True), 1e-9)
        pos_ids = jax.vmap(lambda k, pr: jax.random.choice(k, num_sample, (num_pos,), p=pr))(
            jax.random.split(k2, num_sample), pos_p)
        neg_ids = jax.vmap(lambda k, pr: jax.random.choice(k, num_sample, (num_neg,), p=pr))(
            jax.random.split(k3, num_sample), neg_p)
        return ids, pos_ids, neg_ids

    keys = jax.random.split(key, vert_mask.shape[0])
    out = jax.vmap(per_sample)(keys, jnp.asarray(gt_skin), jnp.asarray(vert_mask))
    return tuple(np.asarray(x).astype(np.int64) for x in out)
