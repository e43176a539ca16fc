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
(exact ties in the max, whose gradient both sides split equally); the
128- and 256-wide layers against the package's Pallas trainable kernel in
interpret mode (`jax_training_kernels`), each side's route counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.kernels import neighbors as jnbk
from morig_tpu.nn import gcu as jgcu
from morig_tpu_torch import weights as W
from morig_tpu_torch.core.batch import MeshBatch
from morig_tpu_torch.kernels import gather_fused as tgf
from morig_tpu_torch.kernels import neighbors as tnbk
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.weights import randomize_

import torch_port_fixtures as F
from torch_port_fixtures import LAYER, LAYER_GRAD, assert_rel_close

# fp32 on both sides, the same operations in other summation orders (the
# gather's transpose, the W2 product, the LayerNorm sums): measured max
# |err| / max |ref| <= 6.3e-7 over the output and every gradient at H = 16,
# 32 and 64 (dense_1_kernel at H = 64 the largest), held at 1e-5.
NARROW_TOL = 1e-5
FIN = 5


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


def _jax_layer(H, x, nbr, mask, dout, seed):
    """JAX's EdgeMLP([H, H]) in training: (params, output, gradient of
    sum(out * dout) by parameter and by x)."""
    m = jgcu.EdgeMLP([H, H])
    args = (jnp.asarray(nbr), jnp.asarray(mask))
    params = F.flax_params(m, seed, jnp.asarray(x), *args, True)

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


def _held(got, ref, what):
    got, ref = F.np_(got).astype(np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= NARROW_TOL, (what, err)


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
    narrow route (one `narrow_edge` call, no K1/K6 trainable)."""
    x, nbr, mask, rng = _tables(seed=H)
    dout = rng.standard_normal((2, 40, H)).astype(np.float32)
    params, yj, gj, gxj = _jax_layer(H, x, nbr, mask, dout, seed=H + 1)
    calls = _spy_trainable(monkeypatch)
    before = tgcu.narrow_edge.launches
    layer, y, gx = _port_layer(H, params, x, nbr, mask, dout)
    assert layer.train_route == "narrow" and layer.kernel_route
    assert tgcu.narrow_edge.launches == before + 1 and calls == []
    _held(y, yj, "out")
    _held(gx, gxj, "x")
    assert {n for n, _ in layer.named_parameters()} == set(gj)
    for n, p in layer.named_parameters():
        _held(p.grad, gj[n], n)
    assert (F.np_(y)[0, 5] == 0).all()          # the vertex with no valid edge


def test_narrow_layer_takes_the_tables_reverse_table_and_no_window(monkeypatch):
    """With the table's masked reverse table (as a MeshBatch holds it) the
    gradients equal those without one bit for bit (the masked edges add
    zeros), the table reaches the gather's backward, and an `edge_tile`
    does not window a narrow layer (JAX's gate ignores windowing there)."""
    x, nbr, mask, rng = _tables(B=2, V=384, D=8, seed=3)
    dout = rng.standard_normal((2, 384, 16)).astype(np.float32)
    m = jgcu.EdgeMLP([16, 16])
    params = F.flax_params(m, 4, jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(mask), True)
    rev = tgf.reverse_table(torch.tensor(nbr), 384, torch.tensor(mask))
    seen = []
    gather = tgcu.gather_rows_trainable

    def spy(values, idx, rev=None):
        seen.append(rev)
        return gather(values, idx, rev)

    monkeypatch.setattr(tgcu, "gather_rows_trainable", spy)
    calls = _spy_trainable(monkeypatch)
    runs = [_port_layer(16, params, x, nbr, mask, dout, r, tile)
            for r, tile in ((None, None), (rev, 128))]
    assert seen[0] is None and seen[1] is rev and calls == []
    (l0, y0, gx0), (l1, y1, gx1) = runs
    assert torch.equal(y0, y1) and torch.equal(gx0, gx1)
    for (n, p), q in zip(l0.named_parameters(), l1.parameters()):
        assert torch.equal(p.grad, q.grad), n


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
    calls = _spy_trainable(monkeypatch)
    before = tgcu.narrow_edge.launches
    layer, y, gx = _port_layer(H, params, x, nbr, mask, dout)
    assert layer.train_route == "kernel"
    assert calls == [(H, H)] and tgcu.narrow_edge.launches == before
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
    the narrow route with the batch's cached reverse tables
    (`MeshBatch.tpl_rev`, `geo_rev`)."""
    entries, _ = F.capsule_inputs()
    _, mesh = F.meshes(entries)
    assert isinstance(mesh, MeshBatch)
    revs = []
    gather = tgcu.gather_rows_trainable

    def spy(values, idx, rev=None):
        revs.append(rev)
        return gather(values, idx, rev)

    monkeypatch.setattr(tgcu, "gather_rows_trainable", spy)
    before = tgcu.narrow_edge.launches
    net = randomize_(tgcu.GCU(3, 32), 5)
    net(mesh.verts, mesh, train=True).sum().backward()
    assert len(revs) == 2 and revs[0] is mesh.tpl_rev and revs[1] is mesh.geo_rev
    assert tgcu.narrow_edge.launches == before + 2
    with torch.no_grad():
        net(mesh.verts, mesh, train=False)
    assert len(revs) == 2 and tgcu.narrow_edge.launches == before + 2   # inference: K1
