"""The port's training route for each edge layer width against the JAX
package, on the CPU.

The JAX package trains an EdgeMLP through its Pallas kernels only where
H1 >= 128 and H1, H2 are multiples of 128 (`gcu._fusable`) and every
narrower layer through its fp32 XLA tail; the port does the same
(`nn.gcu.jax_kernel_widths`, `EdgeMLP.train_route`): K1 + K6 from 128,
`nn.gcu.narrow_edge` below.  The narrow layers are held against the
unpatched package (no fixture: its own width rule and CPU refusal send them
to the XLA tail) at fp32 tolerances, forward and every gradient, on tables
with masked edges, a vertex with no valid edge and duplicated neighbours
(exact ties in the max, whose gradient both sides split equally), also
where the LayerNorms' inputs sit far from 0 (the tail's two-pass
statistics) and where both ReLUs' inputs are exactly 0 (their derivative
1/2 there, as jnp.maximum's); the kernel pair's plain versions (KN, KNB)
against autograd and against the package's tail at every width that takes
the narrow route; the 128- and 256-wide layers against the package's
Pallas trainable kernel in interpret mode (`jax_training_kernels`), each
side's route counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.kernels import edge_fused as jef
from morig_tpu.kernels import neighbors as jnbk
from morig_tpu.nn import gcu as jgcu
from morig_tpu_torch import weights as W
from morig_tpu_torch.core.batch import MeshBatch
from morig_tpu_torch.kernels import gather_fused as tgf
from morig_tpu_torch.kernels import narrow_edge as tne
from morig_tpu_torch.kernels import neighbors as tnbk
from morig_tpu_torch.nn import bonenet, corrnet, deformnet, rignet
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.weights import randomize_

import torch_port_fixtures as F
from torch_port_fixtures import LAYER, LAYER_GRAD, assert_rel_close

# fp32 on both sides, the same operations in other summation orders (the
# gather's transpose, the W2 product, the LayerNorm sums): measured max
# |err| / max |ref| <= 6.3e-7 over the output and every gradient at H = 16,
# 32 and 64 (dense_1_kernel at H = 64 the largest), held at 1e-5.
NARROW_TOL = 1e-5
# The LayerNorms' inputs at mean OFFSET (a's bias and W2's bias shifted by
# it) and spread about 1: fp32 resolves such inputs to ~OFFSET * 2^-24 on
# each side, so the two sides part by up to 2.3e-4 of the largest entry
# with the two-pass statistics (measured at H = 16, 32, 64; held at
# OFFSET_TOL), and by 6e-2 to 0.4 with max(E[x^2] - E[x]^2, 0).
OFFSET, OFFSET_TOL = 1024.0, 1e-3
FIN = 5
NAMES = ("da", "db", "dw2", "db2", "dg1", "dbe1", "dg2", "dbe2")


def _tables(B=2, V=40, D=6, seed=0, dup=True):
    """Random tables with slot 0 the self loop, ~20% of the other edges
    masked, vertex 5 of batch row 0 with no valid edge and, with `dup`,
    slot 3 a copy of slot 2 (exact ties in the max where both are valid)."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, V, (B, V, D))
    nbr[:, :, 0] = np.arange(V)
    if dup:
        nbr[:, :, 3] = nbr[:, :, 2]
    mask = rng.random((B, V, D)) < 0.8
    mask[:, :, 0] = True
    mask[0, 5, :] = False
    x = rng.standard_normal((B, V, FIN)).astype(np.float32)
    return x, nbr, mask, rng


def _jax_layer(H, x, nbr, mask, dout, seed, edit=None):
    """JAX's EdgeMLP([H, H]) in training: (params, output, gradient of
    sum(out * dout) by parameter and by x); `edit(params)` changes the
    seeded parameters in place first."""
    m = jgcu.EdgeMLP([H, H])
    args = (jnp.asarray(nbr), jnp.asarray(mask))
    params = F.flax_params(m, seed, jnp.asarray(x), *args, True)
    if edit is not None:
        edit(params)

    def f(p, x):
        y = m.apply({"params": p}, x, *args, train=True)
        return (y * dout).sum(), y

    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return params, y, W.flax_to_state_dict(jax.tree.map(np.asarray, gp)), gx


def _port_layer(H, params, x, nbr, mask, dout, rev=None, edge_tile=None):
    """The port's EdgeMLP(FIN, [H, H]) with JAX's parameters in training:
    (module, output, x's gradient), each parameter's gradient on it."""
    layer = tgcu.EdgeMLP(FIN, [H, H])
    layer.load_state_dict(W.flax_to_state_dict(params), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    y = layer(xt, torch.tensor(nbr), torch.tensor(mask), edge_tile, True, rev)
    (y * torch.tensor(dout)).sum().backward()
    return layer, y.detach(), xt.grad


def _held(got, ref, what, tol=NARROW_TOL):
    got, ref = F.np_(got).astype(np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, (what, err)


def _spy_narrow(monkeypatch):
    """The `rev` each `narrow_edge_trainable` call (KN + KNB) receives."""
    seen = []
    trainable = tgcu.narrow_edge_trainable

    def spy(*args, rev=None):
        seen.append(rev)
        return trainable(*args, rev=rev)

    monkeypatch.setattr(tgcu, "narrow_edge_trainable", spy)
    return seen


def _spy_trainable(monkeypatch):
    calls = []
    trainable = tgcu.fused_edge_mlp_trainable

    def spy(*args, **kw):
        calls.append(tuple(args[4].shape))
        return trainable(*args, **kw)

    monkeypatch.setattr(tgcu, "fused_edge_mlp_trainable", spy)
    return calls


@pytest.mark.parametrize("H", [16, 32, 64])
def test_narrow_layer_trains_as_the_unpatched_package(H, monkeypatch):
    """An EdgeMLP narrower than 128 in training: the output and the
    gradients of x, lin_self, lin_nbr, W2, b2 and both LayerNorms within
    NARROW_TOL of the JAX package's own training path; the layer takes the
    narrow route (one `narrow_edge_trainable` call, no K1/K6 trainable)."""
    x, nbr, mask, rng = _tables(seed=H)
    dout = rng.standard_normal((2, 40, H)).astype(np.float32)
    params, yj, gj, gxj = _jax_layer(H, x, nbr, mask, dout, seed=H + 1)
    calls, narrow = _spy_trainable(monkeypatch), _spy_narrow(monkeypatch)
    layer, y, gx = _port_layer(H, params, x, nbr, mask, dout)
    assert layer.train_route == "narrow" and layer.kernel_route
    assert len(narrow) == 1 and calls == []
    _held(y, yj, "out")
    _held(gx, gxj, "x")
    assert {n for n, _ in layer.named_parameters()} == set(gj)
    for n, p in layer.named_parameters():
        _held(p.grad, gj[n], n)
    assert (F.np_(y)[0, 5] == 0).all()          # the vertex with no valid edge


def test_narrow_layer_takes_the_tables_reverse_table_and_no_window(monkeypatch):
    """With the table's masked reverse table (as a MeshBatch holds it) the
    gradients equal those without one bit for bit (the masked edges add
    zeros), the table reaches the kernel pair (KNB's db_table sum), and an
    `edge_tile` does not window a narrow layer (JAX's gate ignores
    windowing there)."""
    x, nbr, mask, rng = _tables(B=2, V=384, D=8, seed=3)
    dout = rng.standard_normal((2, 384, 16)).astype(np.float32)
    m = jgcu.EdgeMLP([16, 16])
    params = F.flax_params(m, 4, jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(mask), True)
    rev = tgf.reverse_table(torch.tensor(nbr), 384, torch.tensor(mask))
    seen = _spy_narrow(monkeypatch)
    calls = _spy_trainable(monkeypatch)
    runs = [_port_layer(16, params, x, nbr, mask, dout, r, tile)
            for r, tile in ((None, None), (rev, 128))]
    assert seen[0] is None and seen[1] is rev and calls == []
    (l0, y0, gx0), (l1, y1, gx1) = runs
    assert torch.equal(y0, y1) and torch.equal(gx0, gx1)
    for (n, p), q in zip(l0.named_parameters(), l1.parameters()):
        assert torch.equal(p.grad, q.grad), n


def _offset(params):
    params["lin_self"]["bias"] = params["lin_self"]["bias"] + np.float32(OFFSET)
    params["dense_1_bias"] = params["dense_1_bias"] + np.float32(OFFSET)


@pytest.mark.parametrize("H", [16, 32, 64])
def test_narrow_layer_two_pass_statistics_on_offset_inputs(H, monkeypatch):
    """The narrow layer where both LayerNorms' inputs sit at mean OFFSET with
    spread about 1 (|mu| / sigma ~ 700-1000: a's bias and W2's bias shifted
    by OFFSET): output and every gradient within OFFSET_TOL of the unpatched
    package, whose `_ln` takes the variance in two passes; the one-pass
    max(E[x^2] - E[x]^2, 0) parts from it by 6e-2 or more there."""
    x, nbr, mask, rng = _tables(seed=H)
    dout = rng.standard_normal((2, 40, H)).astype(np.float32)
    params, yj, gj, gxj = _jax_layer(H, x, nbr, mask, dout, seed=H + 1, edit=_offset)
    layer, y, gx = _port_layer(H, params, x, nbr, mask, dout)
    with torch.no_grad():
        r = layer.lin_self(torch.tensor(x)) + layer.lin_nbr(torch.tensor(x))
    assert (r.mean(-1).abs() / r.std(-1)).min() >= 100
    _held(y, yj, "out", OFFSET_TOL)
    _held(gx, gxj, "x", OFFSET_TOL)
    for n, p in layer.named_parameters():
        if n != "ln1_bias":                      # dy's sum: no LayerNorm in its way
            _held(p.grad, gj[n], n, OFFSET_TOL)


def _zero_rows(params):
    for tree, key in ((params["lin_self"], "bias"), (params, "dense_1_bias"),
                      (params, "ln0_bias")):
        tree[key] = np.zeros_like(tree[key])


@pytest.mark.parametrize("H", [8, 16, 32, 64])
def test_narrow_relu_gradient_at_zero_is_half(H):
    """Vertices 10-19 of batch row 0 with zero features whose every edge
    points among themselves, at zero biases of lin_self, W2 and LN1: both
    ReLUs' inputs of those edges are exactly 0 (a = b = 0; LN1 of the zero
    row is be1 = 0, then h W2 + b2 = 0), where jnp.maximum's derivative is
    1/2.  Output and every gradient within NARROW_TOL of the unpatched
    package; those rows' gradient of x, which flows only through the ReLUs
    at 0 (with relu'(0) = 0 it would be 0), is nonzero."""
    x, nbr, mask, rng = _tables(seed=H + 7)
    x[0, 10:20] = 0.0
    nbr[0, 10:20] = rng.integers(10, 20, (10, nbr.shape[-1]))
    mask[0, 10:20] = True
    nbr[:, :, 0] = np.arange(40)
    far = (nbr[0, :10] >= 10) & (nbr[0, :10] < 20)       # other rows leave the zero block
    nbr[0, :10][far] = 0
    nbr[0, 20:][(nbr[0, 20:] >= 10) & (nbr[0, 20:] < 20)] = 20
    dout = rng.standard_normal((2, 40, H)).astype(np.float32)
    params, yj, gj, gxj = _jax_layer(H, x, nbr, mask, dout, seed=H + 8, edit=_zero_rows)
    layer, y, gx = _port_layer(H, params, x, nbr, mask, dout)
    assert np.abs(np.asarray(gxj)[0, 10:20]).max() > 0
    _held(y, yj, "out")
    _held(gx, gxj, "x")
    for n, p in layer.named_parameters():
        _held(p.grad, gj[n], n)


def _jax_tail(a, b, nbr, mask, w2, b2, g1, be1, g2, be2):
    """The package's fp32 XLA tail of a narrow edge layer in training, its
    own lines (morig_tpu/nn/gcu.py EdgeMLP) on given a and b."""
    h = jnp.maximum(a[:, :, None, :] + jgcu.gather_nbrs(b, nbr), 0.0)
    h = jef._ln(h, g1, be1)
    h = jnp.maximum(h @ w2 + b2, 0.0)
    h = jef._ln(h, g2, be2)
    return jnbk.masked_max(h, mask, axis=2)


def _tail_inputs(H, seed):
    _, nbr, mask, rng = _tables(seed=seed)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    a, b = f32(2, 40, H), f32(2, 40, H)
    w2 = f32(H, H) / np.float32(np.sqrt(H))
    g1, g2 = (rng.uniform(0.5, 1.5, H).astype(np.float32) for _ in range(2))
    b2, be1, be2 = (0.1 * f32(H) for _ in range(3))
    return (a, b, nbr, mask, w2, b2, g1, be1, g2, be2), f32(2, 40, H)


@pytest.mark.parametrize("H", tne.NARROW_WIDTHS)
def test_narrow_bwd_plain_matches_autograd_and_the_package(H):
    """KN's and KNB's plain versions at every width of the narrow route, on
    tables with masked edges, a vertex with no valid edge and duplicated
    neighbours (exact ties): `narrow_edge_bwd_plain` against autograd of
    `narrow_edge_plain` and both against the package's tail and its
    jax.grad, within NARROW_TOL; db_table over the masked reverse table
    equal to the one without it bit for bit."""
    args, dout = _tail_inputs(H, seed=H + 11)
    a, b, nbr, mask, *params = (torch.tensor(t) for t in args)
    leaves = [t.clone().requires_grad_() for t in (a, b, *params)]
    y = tne.narrow_edge_plain(leaves[0], leaves[1], nbr, mask, *leaves[2:])
    (y * torch.tensor(dout)).sum().backward()
    grads = tne.narrow_edge_bwd_plain(a, b, nbr, mask, *params, torch.tensor(dout))
    rev = tgf.reverse_table(nbr, nbr.shape[1], mask)
    again = tne.narrow_edge_bwd_plain(a, b, nbr, mask, *params, torch.tensor(dout), rev)
    assert all(torch.equal(x, z) for x, z in zip(grads, again))
    ja = [jnp.asarray(t) for t in args]
    yj, vjp = jax.vjp(lambda a, b, *p: _jax_tail(a, b, ja[2], ja[3], *p), *ja[:2], *ja[4:])
    gj = vjp(jnp.asarray(dout))
    _held(y.detach(), yj, "out")
    assert (F.np_(y)[0, 5] == 0).all()
    for name, g, auto, ref in zip(NAMES, grads, [t.grad for t in leaves], gj):
        _held(g, auto, f"{name} (autograd)")
        _held(g, ref, f"{name} (jax)")


def test_narrow_widths_are_the_kernels():
    """Every width that takes the narrow route, in the networks with
    narrow layers at full width and at the tests' width_scale 0.25, is one
    KN and KNB take, and together they are NARROW_WIDTHS; the kernels'
    argument check refuses any other width (before any launch)."""
    nets = [corrnet.CorrNet(), deformnet.DeformNet(), bonenet.BoneNet(), bonenet.RootNet()]
    for scale in (1.0, 0.25):
        nets += [rignet.JointNetMotion(width_scale=scale), rignet.MaskNetMotion(width_scale=scale),
                 rignet.SkinMotion(width_scale=scale)]
    widths = {m.dense_1_kernel.shape[0] for net in nets for m in net.modules()
              if isinstance(m, tgcu.EdgeMLP) and m.train_route == "narrow"}
    assert widths == set(tne.NARROW_WIDTHS), widths
    args, _ = _tail_inputs(12, seed=1)
    with pytest.raises(ValueError, match="narrow edge kernel takes equal widths"):
        tne._kernel_args(*(torch.tensor(t) for t in args))


def test_masked_max_splits_the_gradient_among_ties_as_jnp_max():
    """masked_max's gradient at exact ties is jnp.max's: split equally
    among the tied maxima (0.5 each for two), 0 at masked entries and where
    no entry is valid; `max(dim).values` would send it to one."""
    x = np.array([[[1.0, 3.0], [3.0, 2.0], [3.0, 3.0], [0.5, 9.0]],
                  [[2.0, 2.0], [2.0, 2.0], [2.0, 2.0], [2.0, 2.0]]], np.float32)
    mask = np.array([[True, True, True, False], [False, False, False, False]])
    w = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    gj = jax.grad(lambda v: (jnbk.masked_max(v, jnp.asarray(mask), axis=1) * w).sum())(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (tnbk.masked_max(xt, torch.tensor(mask), dim=1) * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    assert xt.grad[0, :, 0].tolist() == [0.0, 0.5, 0.5, 0.0]
    assert xt.grad[0, :, 1].tolist() == [1.0, 0.0, 1.0, 0.0]     # [3, 2, 3] x weight 2
    assert (xt.grad[1] == 0).all()


@pytest.mark.parametrize("H", [128, 256])
def test_kernel_width_layer_trains_as_the_package_kernel(H, monkeypatch):
    """An EdgeMLP of 128 or 256 in training: the port's K1 + K6 trainable
    (their plain versions on the CPU) against the JAX package's Pallas
    trainable kernel in interpret mode (the package's width rule taking
    it), output at LAYER and gradients at LAYER_GRAD (both sides round the
    tail's operands to bf16); each side took its kernel route once."""
    x, nbr, mask, rng = _tables(B=2, V=128, D=12, seed=H, dup=False)
    dout = rng.standard_normal((2, 128, H)).astype(np.float32)
    with F.jax_training_kernels() as routes:
        params, yj, gj, gxj = _jax_layer(H, x, nbr, mask, dout, seed=H + 1)
    assert set(routes.pallas) == {(H, H)}        # (traced more than once)
    calls, narrow = _spy_trainable(monkeypatch), _spy_narrow(monkeypatch)
    layer, y, gx = _port_layer(H, params, x, nbr, mask, dout)
    assert layer.train_route == "kernel"
    assert calls == [(H, H)] and narrow == []
    assert_rel_close(y, yj, LAYER, what="out")
    assert_rel_close(gx, gxj, LAYER_GRAD, what="x")
    for n, p in layer.named_parameters():
        assert_rel_close(p.grad, gj[n], LAYER_GRAD, what=n)


def test_routes_follow_the_package_width_rule():
    """`jax_kernel_widths` is the width rule of the package's `_fusable`
    (which also asks "layer" mode, two channels, V a multiple of the
    vertex tile and a non-CPU backend); a layer takes K1 + K6 where the
    rule and the port's kernels both take its widths, the fp32 tail
    otherwise, and "batch" mode has no route."""
    for h1, h2 in ((16, 16), (32, 32), (64, 64), (8, 8), (128, 128), (256, 256),
                   (128, 64), (384, 384), (512, 512)):
        rule = h1 >= 128 and h1 % 128 == 0 and h2 % 128 == 0
        assert tgcu.jax_kernel_widths(h1, h2) == rule
        route = tgcu.EdgeMLP(3, [h1, h2]).train_route
        assert route == ("kernel" if rule and tgcu.kernel_widths(h1, h2) else "narrow"), (h1, h2)
    with F.norm_mode("batch"):
        assert tgcu.EdgeMLP(3, [16, 16]).train_route is None


def test_gcu_narrow_layers_read_the_batch_reverse_tables(monkeypatch):
    """A GCU(3, 32) in training on a MeshBatch: both 16-wide edge layers take
    the narrow route (KN + KNB) with the batch's cached reverse tables
    (`MeshBatch.tpl_rev`, `geo_rev`)."""
    entries, _ = F.capsule_inputs()
    _, mesh = F.meshes(entries)
    assert isinstance(mesh, MeshBatch)
    revs = _spy_narrow(monkeypatch)
    net = randomize_(tgcu.GCU(3, 32), 5)
    net(mesh.verts, mesh, train=True).sum().backward()
    assert len(revs) == 2 and revs[0] is mesh.tpl_rev and revs[1] is mesh.geo_rev
    with torch.no_grad():
        net(mesh.verts, mesh, train=False)
    assert len(revs) == 2                                               # inference: K1
