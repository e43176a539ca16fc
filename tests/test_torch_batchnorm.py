"""The "batch" norm mode of morig_tpu_torch against the JAX package's:
MaskedBatchNorm, then MLP, EdgeMLP, GCU and GCUMotion built in that mode,
on the same parameters and running statistics (flax_to_state_dict with
batch_stats), in inference, in training (output and updated running
statistics) and backward (input and parameter gradients).

Everything is fp32 on both sides: the JAX package runs no Pallas kernel in
this mode (`gcu._fusable` refuses it) and its MLPs compute in fp32
(`infer_matmul_dtype`), so the differences are fp32 sums in another order.
Tolerances:
  * MaskedBatchNorm: outputs and input gradients within 1e-5 (absolute and
    relative), running means and variances within 1e-6 relative.
  * MODULE (the modules, relative to the reference's mean and max
    magnitude as `assert_rel_close` takes them): outputs and gradients
    through two edge layers, a max over the table and a fuse MLP, each with
    batch statistics; the running statistics are held like the
    MaskedBatchNorm ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.nn import gcu as jgcu
from morig_tpu.nn import mlp as jmlp
from morig_tpu.nn import norm as jnorm
from morig_tpu_torch import weights as W
from morig_tpu_torch.kernels import edge_fused
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.nn import mlp as tmlp
from morig_tpu_torch.nn.norm import MaskedBatchNorm

import torch_port_fixtures as F
from torch_port_fixtures import assert_rel_close

MODULE = (1e-5, 1e-4)


@pytest.fixture
def batch_mode():
    with F.norm_mode("batch"):
        yield


def _close(got, ref, atol, rtol, what):
    F.assert_close(got, ref, atol=atol, rtol=rtol, what=what)


def _stats_close(got: dict, ref: dict, what: str):
    """Every running mean and variance of the port's state dict `got`
    against the flax batch_stats `ref`, 1e-6 relative to the tensor's scale."""
    ref_sd = W.flax_to_state_dict({}, ref)
    stats = {k: v for k, v in got.items() if k.endswith(("running_mean", "running_var"))}
    assert set(stats) == set(ref_sd), (what, sorted(set(stats) ^ set(ref_sd)))
    for k, v in ref_sd.items():
        scale = float(np.abs(v.numpy()).max())
        _close(stats[k], v, 1e-6 * scale, 1e-6, f"{what} {k}")


# ---------------------------------------------------------------------------
# MaskedBatchNorm
# ---------------------------------------------------------------------------

# (x shape, mask shape or None): 2-D to 4-D inputs, a mask over every axis
# but the channel, over a shorter prefix, or none
CASES = [((96, 24), None), ((96, 24), (96,)),
         ((3, 40, 16), None), ((3, 40, 16), (3, 40)),
         ((2, 30, 6, 8), None), ((2, 30, 6, 8), (2, 30)), ((2, 30, 6, 8), (2, 30, 6))]


def _bn_pair(C, seed, var0=None):
    """A flax MaskedBatchNorm's variables and the port's module with them."""
    rng = np.random.default_rng(seed)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": (0.2 * rng.standard_normal(C)).astype(np.float32)}
    stats = {"mean": (0.5 * rng.standard_normal(C)).astype(np.float32),
             "var": (rng.uniform(0.5, 2.0, C) if var0 is None else np.full(C, var0)
                     ).astype(np.float32)}
    bn = MaskedBatchNorm(C)
    bn.load_state_dict({"weight": torch.as_tensor(params["scale"]),
                        "bias": torch.as_tensor(params["bias"]),
                        **W.flax_to_state_dict({}, stats)}, strict=True)
    return params, stats, bn


def _bn_against_jax(x, mask, train, params, stats, bn, what):
    """Output, running statistics and input gradient of `bn` against flax."""
    jbn = jnorm.MaskedBatchNorm()
    jmask = None if mask is None else jnp.asarray(mask)
    dout = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jfwd(x_):
        return jbn.apply({"params": params, "batch_stats": stats}, x_, jmask, train,
                         mutable=["batch_stats"])

    ref, vjp, upd = jax.vjp(jfwd, jnp.asarray(x), has_aux=True)
    (jdx,) = vjp(jnp.asarray(dout))
    tx = torch.as_tensor(x).requires_grad_()
    y = bn(tx, None if mask is None else torch.as_tensor(mask), train)
    y.backward(torch.as_tensor(dout))
    _close(y, ref, 1e-5, 1e-5, f"{what} output")
    _close(tx.grad, jdx, 1e-5, 1e-5, f"{what} input gradient")
    _stats_close(dict(bn.state_dict()), upd["batch_stats"], what)
    return y


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("shape,mask_shape", CASES)
def test_masked_batch_norm_matches_flax(shape, mask_shape, train):
    """Inference (running statistics) and training (masked batch statistics,
    the running statistics updated with the unbiased variance)."""
    rng = np.random.default_rng(len(shape) * 10 + (mask_shape is not None))
    x = (rng.standard_normal(shape) * rng.uniform(0.2, 3.0, shape[-1])
         + rng.standard_normal(shape[-1])).astype(np.float32)
    mask = None if mask_shape is None else rng.random(mask_shape) < 0.7
    params, stats, bn = _bn_pair(shape[-1], 3)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    _bn_against_jax(x, mask, train, params, stats, bn, f"{shape} mask {mask_shape}")
    moved = not torch.equal(before["running_mean"], bn.running_mean)
    assert moved == train


def test_masked_batch_norm_ignores_padded_values():
    """A padded batch: changing the padded entries changes no valid output,
    neither running statistic, nor any valid input gradient, in training."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 50, 12)).astype(np.float32)
    mask = np.ones((2, 50), bool)
    mask[0, 35:] = mask[1, 20:] = False
    outs = []
    for fill in (0.0, 1e3):
        xp = np.where(mask[..., None], x, fill + rng.standard_normal(x.shape)).astype(np.float32)
        params, stats, bn = _bn_pair(12, 5)
        y = _bn_against_jax(xp, mask, True, params, stats, bn, f"padding {fill}")
        outs.append((y.detach()[torch.as_tensor(mask)], bn.running_mean.clone(),
                     bn.running_var.clone()))
    for a, b in zip(*outs):
        _close(a, b, 1e-5, 1e-5, "padded values")


def test_masked_batch_norm_small_variance_channel():
    """A channel of variance 1e-8 around 0.1 (a post-ReLU channel of small
    inputs): the two-pass variance keeps it, where E[x^2] - mean^2 would
    lose it to fp32 cancellation.  The running variance starts at 0 so the
    batch's variance is what it holds."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((200, 4)).astype(np.float32)
    x[:, 2] = 0.1 + 1e-4 * rng.standard_normal(200)
    params, stats, bn = _bn_pair(4, 9, var0=0.0)
    _bn_against_jax(x, None, True, params, stats, bn, "small variance")
    var = float(np.var(x[:, 2].astype(np.float64), ddof=1))
    assert abs(bn.running_var[2].item() - 0.1 * var) <= 1e-3 * 0.1 * var


# ---------------------------------------------------------------------------
# MLP, EdgeMLP, GCU, GCUMotion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    entries, _ = F.capsule_inputs(2)
    jm, tm = F.meshes(entries)
    return dict(jm=jm, tm=tm, vm=np.asarray(jm.vert_mask))


def _module_against_jax(jmod, make_port, jargs, targs, x_index, seed, mask, what):
    """`jmod` (flax, "batch" mode) and the port's module `make_port()` on the
    same variables: the inference output; the training output, updated
    running statistics, input gradient (argument `x_index`) and parameter
    gradients.  `mask` selects the valid rows of the outputs."""
    params, stats = F.flax_variables(jmod, seed, *jargs, False)
    net = F.bridged(make_port, W.flax_to_state_dict(params, stats))
    launches = {k: getattr(edge_fused, k).launches
                for k in ("fused_edge_mlp", "fused_edge_mlp_windowed", "fused_edge_mlp_bwd")}
    plain = tgcu.plain_edge.launches

    ref = jmod.apply({"params": params, "batch_stats": stats}, *jargs, False)
    assert_rel_close(net(*targs, train=False), ref, MODULE, mask, f"{what} inference")

    x = np.asarray(jargs[x_index])
    dout = np.random.default_rng(seed).standard_normal(np.shape(ref)).astype(np.float32)

    def jfwd(p_, x_):
        a = list(jargs)
        a[x_index] = x_
        return jmod.apply({"params": p_, "batch_stats": stats}, *a, True,
                          mutable=["batch_stats"])

    ref, vjp, upd = jax.vjp(jfwd, params, jnp.asarray(x), has_aux=True)
    jdp, jdx = vjp(jnp.asarray(dout))
    tx = torch.as_tensor(x).requires_grad_()
    a = list(targs)
    a[x_index] = tx
    y = net(*a, train=True)
    y.backward(torch.as_tensor(dout))
    assert_rel_close(y, ref, MODULE, mask, f"{what} training")
    _stats_close(dict(net.state_dict()), upd["batch_stats"], what)
    assert_rel_close(tx.grad, jdx, MODULE, mask, f"{what} input gradient")
    ref_grads = W.flax_to_state_dict(jdp)
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert set(grads) == set(ref_grads)
    for n, g in grads.items():
        assert_rel_close(g, ref_grads[n], MODULE, what=f"{what} d{n}")
    # no edge kernel, nor K1's plain version, in this mode
    assert plain == tgcu.plain_edge.launches
    for k, n in launches.items():
        assert getattr(edge_fused, k).launches == n, k


def test_mlp_and_head_batch_mode_match_flax(batch_mode, mesh):
    """MLPHead (an MLP of three stages and its output Linear) over the
    vertices, masked by the vertex mask."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, F.V_PAD, 24)).astype(np.float32)
    jm, tm = mesh["jm"], mesh["tm"]
    _module_against_jax(
        jmlp.MLPHead([64, 48, 32], 5), lambda: tmlp.MLPHead(24, [64, 48, 32], 5),
        (jnp.asarray(x), jm.vert_mask), (torch.as_tensor(x), tm.vert_mask), 0, 2,
        mesh["vm"], "MLPHead")


def test_edge_mlp_batch_mode_matches_flax(batch_mode, mesh):
    """One EdgeMLP [32, 32] over the tpl table: BN over the (B, V, D, H)
    edge tensor masked by the table's validity, twice, then the max."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, F.V_PAD, 16)).astype(np.float32)
    jm, tm = mesh["jm"], mesh["tm"]
    _module_against_jax(
        jgcu.EdgeMLP([32, 32]), lambda: tgcu.EdgeMLP(16, [32, 32]),
        (jnp.asarray(x), jm.tpl_nbr, jm.tpl_mask), (torch.as_tensor(x), tm.tpl_nbr, tm.tpl_mask),
        0, 3, mesh["vm"], "EdgeMLP")


@pytest.mark.parametrize("H", [32, 128])
def test_gcu_batch_mode_matches_flax(batch_mode, mesh, H):
    rng = np.random.default_rng(H)
    x = rng.standard_normal((2, F.V_PAD, 64)).astype(np.float32)
    jm, tm = mesh["jm"], mesh["tm"]
    _module_against_jax(jgcu.GCU(H), lambda: tgcu.GCU(64, H), (jnp.asarray(x), jm),
                        (torch.as_tensor(x), tm), 0, H, mesh["vm"], f"GCU{H}")


@pytest.mark.parametrize("H,dp", [(64, 16), (128, 64)])
def test_gcu_motion_batch_mode_matches_flax(batch_mode, mesh, H, dp):
    rng = np.random.default_rng(H + dp)
    x = rng.standard_normal((2, F.V_PAD, 32)).astype(np.float32)
    jm, tm = mesh["jm"], mesh["tm"]
    pos = np.asarray(jm.verts)
    _module_against_jax(jgcu.GCUMotion(H, dim_pos_feat=dp), lambda: tgcu.GCUMotion(3, 32, H, dp),
                        (jnp.asarray(pos), jnp.asarray(x), jm),
                        (torch.as_tensor(pos), torch.as_tensor(x), tm), 1, H + dp, mesh["vm"],
                        f"GCUMotion{H}")


def test_modules_read_the_mode_when_built():
    """A module keeps the mode it was built in: its parameters and buffers
    follow that mode whatever the mode is when it runs."""
    with F.norm_mode("batch"):
        bn_net = tgcu.GCU(8, 32)
    with F.norm_mode("none"):
        plain_net = tgcu.GCU(8, 32)
    layer_net = tgcu.GCU(8, 32)
    keys = {n: set(m.state_dict()) for n, m in (("batch", bn_net), ("none", plain_net),
                                                 ("layer", layer_net))}
    assert "edge_conv_tpl.nn_pos.norm_0.bn.running_var" in keys["batch"]
    assert "mlp.bn_0.running_mean" in keys["batch"]
    assert not any("bn" in k or "ln" in k for k in keys["none"])
    assert "edge_conv_tpl.nn_pos.ln0_scale" in keys["layer"] and "mlp.ln_0.weight" in keys["layer"]
    assert tmlp.get_default_norm() == "layer"
    with pytest.raises(ValueError):
        tmlp.set_default_norm("group")
