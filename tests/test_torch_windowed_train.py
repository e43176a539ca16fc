"""Training through the windowed edge kernel (K5 forward, K6 backward) and
the ordered row scatter, against the JAX package on the CPU.

On a CPU tensor the port runs the plain versions: `edge_mlp_windowed_plain`
forward and `edge_mlp_bwd_plain` backward in the K5 trainable, `index_add_`
in the ordered scatter; the JAX side runs its Pallas kernels in interpret
mode (`fused_edge_mlp_trainable(..., windowed=True, pallas_bwd=True)`,
`set_edge_impl("windowed")`).  Inputs come from numpy seeds and go to both
sides; each tolerance is stated with its reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.data import pose as jpose
from morig_tpu.kernels import edge_fused as jef
from morig_tpu.nn import corrnet as jcn
from morig_tpu.nn import gcu as jgcu
from morig_tpu.train import stages as jstages
from morig_tpu_torch import cli as tcli
from morig_tpu_torch import weights as W
from morig_tpu_torch.data import creature as tcr
from morig_tpu_torch.data import pose as tpose
from morig_tpu_torch.data import preprocess as tpre
from morig_tpu_torch.data.rig import RigDataset, RigModel
from morig_tpu_torch.kernels import edge_fused as tef
from morig_tpu_torch.kernels import gather_fused as tgf
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.train import stages as tstages

import torch_port_fixtures as F
from torch_port_fixtures import GRAD, GRAD_TOTAL, NETWORK, assert_close, assert_rel_close

K6_NAMES = ("da", "db_table", "dw2", "db2", "dg1", "dbe1", "dg2", "dbe2")
t = torch.as_tensor


# ---------------------------------------------------------------------------
# the ordered row scatter's plain route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_reverse_table_orders_as_index_add(masked, wide):
    """The reverse table the card's ordered scatter walks: summing each target
    row's sources in the table's order (the kernel's loop, written out here)
    equals `index_add_` on the CPU (`scatter_rows_plain`) bit for bit, masked
    entries left out; `scatter_rows` on the CPU is `index_add_`, and over the
    table `row_scatter_plain`, the same bits.  Indices with heavy repeats (a
    1-NN into few candidates).  The table sorted on 32-bit keys (`wide`
    False, the default at these sizes) equals the one on 64-bit keys, both
    int64."""
    rng = np.random.default_rng(int(masked))
    idx = t(rng.integers(0, 9, (2, 50, 3)))
    rows = t(rng.standard_normal((2, 50, 3, 4)).astype(np.float32))
    mask = t(rng.random((2, 50, 3)) < 0.6) if masked else None
    order, offsets = tgf.reverse_table(idx, 9, mask, wide=wide)
    assert order.dtype == offsets.dtype == torch.int64
    for x, y in zip(tgf.reverse_table(idx, 9, mask, wide=not wide), (order, offsets)):
        assert torch.equal(x, y)                                # the other key width
    assert int(offsets[-1]) == (int(mask.sum()) if masked else idx.numel())
    flat = rows.reshape(-1, 4)
    got = torch.zeros(18, 4)
    for r in range(18):
        for k in range(int(offsets[r]), int(offsets[r + 1])):
            got[r] += flat[order[k]]
        assert bool((order[offsets[r]:offsets[r + 1]].diff() > 0).all())   # flat order
    ref_rows = rows * mask[..., None] if masked else rows
    assert torch.equal(got.reshape(2, 9, 4), tgf.scatter_rows_plain(idx, ref_rows, 9))
    assert torch.equal(tgf.scatter_rows(idx, rows, 9), tgf.scatter_rows_plain(idx, rows, 9))
    assert torch.equal(tgf.row_scatter_plain(flat, order, offsets, 18).reshape(2, 9, 4),
                       got.reshape(2, 9, 4))
    for x, y in zip(tgf.reverse_table(idx, 9, mask), (order, offsets)):     # built again,
        assert torch.equal(x, y)                                            # the same table


def test_gather_rows_trainable_gradient():
    """`gather_rows_trainable` on the CPU: the rows of `gather_plain` and the
    gradient of `torch.gather`'s, within fp32 summation order (1e-6)."""
    rng = np.random.default_rng(4)
    v = t(rng.standard_normal((2, 30, 5)).astype(np.float32))
    idx = t(rng.integers(0, 30, (2, 40)))
    dout = t(rng.standard_normal((2, 40, 5)).astype(np.float32))
    a, b = v.clone().requires_grad_(), v.clone().requires_grad_()
    y = tgf.gather_rows_trainable(a, idx)
    assert torch.equal(y, tgf.gather_plain(v, idx))
    (y * dout).sum().backward()
    (torch.gather(b, 1, idx[..., None].expand(-1, -1, 5)) * dout).sum().backward()
    assert_close(a.grad, b.grad, atol=1e-6, what="gradient")


# ---------------------------------------------------------------------------
# the K5 trainable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [32, 128])
def test_windowed_trainable_matches_pallas_interpret(H):
    """The K5 trainable (port: `edge_mlp_windowed_plain` forward on bf16(a),
    bf16(b), `edge_mlp_bwd_plain` backward) against the JAX package's
    `fused_edge_mlp_trainable(..., windowed=True, pallas_bwd=True)` in
    interpret mode (its windowed kernel at its tile, 256; its backward
    kernel at 128), on tables local at 256 (V=768, D=4, every tile's window
    edges pinned, rows with no valid edge), with a random dout.  Forward as
    K1 (2e-2 absolute on O(1) LayerNorm outputs, mean below 1e-4).  Each
    gradient by its relative L2 error, 2e-4, and fewer than 1e-3 of its
    entries off by more than 1e-3 of max(max |ref|, 1): both sides round h,
    ds and dx to bf16 from fp32 values summed in another order, and dW2 and
    the vector gradients add those over the ~2150 valid edges in another
    order (measured: relative L2 at most 9.1e-5, db_table at H=128; no
    entry off by 1e-3, no route flipped)."""
    from test_edge_fused import make_inputs

    rng = np.random.default_rng(H)
    args = make_inputs(rng, B=1, V=768, D=4, H1=H, H2=H, local=True)
    assert jef.check_neighbor_locality(np.asarray(args[2]), 256)
    dout = rng.standard_normal((1, 768, H)).astype(np.float32)
    a, b, nbr, mask, *tail = args

    def loss(a_, b_, *tail_):
        out = jef.fused_edge_mlp_trainable(a_, b_, nbr, mask, *tail_, True, True, True, 128)
        return jnp.sum(out * dout), out

    (_, ref_out), ref = jax.value_and_grad(loss, argnums=tuple(range(8)), has_aux=True)(
        a, b, *tail)
    leaves = [t(np.array(x)).requires_grad_() for x in (a, b, *tail)]
    out = tef.fused_edge_mlp_trainable(leaves[0], leaves[1], t(np.array(nbr)).long(),
                                       t(np.array(mask)), *leaves[2:], tile_v=256)
    (out * t(dout)).sum().backward()
    assert_close(out, ref_out, atol=2e-2, what="forward")
    assert np.abs(out.detach().numpy() - np.asarray(ref_out)).mean() < 1e-4
    for name, leaf, r in zip(K6_NAMES, leaves, ref):
        g, r = leaf.grad.numpy(), np.asarray(r)
        scale = max(float(np.abs(r).max()), 1.0)
        err = np.abs(g - r)
        assert np.linalg.norm(g - r) <= 2e-4 * np.linalg.norm(r), name
        assert (err > 1e-3 * scale).mean() < 1e-3, (name, err.max(), scale)


# ---------------------------------------------------------------------------
# a CorrPoseStage step through K5
# ---------------------------------------------------------------------------

# capsules of 578 vertices in a 768 bucket: three 256-vertex tiles, the
# least V at which the JAX package's windowed training forward (tile 256)
# engages; ring-ordered, so every table is local
DATA = dict(num_models=2, num_frames=4, num_points=128, n_lat=25, n_lon=24)


@pytest.fixture(scope="module")
def windowed_step():
    """One CorrPoseStage train step on both sides from the same seeded
    weights and batch, the JAX side under set_edge_impl("windowed") (its
    windowed forward and Pallas backward, interpret mode), the port's batch
    stacked with edge_tile=128 by its dataset (K5's plain version forward);
    and the port's gradients of the same step with the batch on the full
    table (K1's plain version)."""
    jds = jpose.PoseDataset(jpose.capsule_pose_dataset(**DATA).models, tpl_max_degree=12,
                            geo_max_degree=12, buckets=(768,))
    tds = tpose.PoseDataset(tpose.capsule_pose_dataset(**DATA).models, tpl_max_degree=12,
                            geo_max_degree=12, buckets=(768,), edge_tile=128)
    jb, tb = jds.batch([0, 1], 0, 2), tds.batch([0, 1], 0, 2, device="cpu")
    assert tb.mesh.edge_tile == 128
    # auto_select_edge_impl sets the JAX package's process-wide impl and tile
    prev = jgcu.get_edge_impl(), jgcu.get_edge_tile()
    try:
        assert jgcu.auto_select_edge_impl(jds._mesh_cache, tile_v=256) == "windowed"
    finally:
        jgcu.set_edge_impl(prev[0])
        jgcu.set_edge_tile(prev[1])
    assert prev[1] == 256
    model = jcn.CorrNet()
    with F.jax_training_kernels("windowed"):
        params = F.flax_params(model, 31, jb.mesh, jb.points, True, True)

        def loss_fn(p):
            outputs = model.apply({"params": p}, jb.mesh, jb.points, True, True, None)
            return jstages.CorrPoseStage()._losses(outputs, jb, True)

        (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert (jgcu.get_edge_impl(), jgcu.get_edge_tile()) == prev
    stage = tstages.CorrPoseStage()
    stage.train_vismask = True
    calls, revs, meshes = [], [], []
    trainable = tgcu.fused_edge_mlp_trainable

    def record(*args, **kw):
        calls.append(kw.get("tile_v"))
        revs.append(kw.get("rev"))
        return trainable(*args, **kw)

    grads = {}
    for name, batch in (("windowed", tb), ("full", dataclasses.replace(
            tb, mesh=dataclasses.replace(tb.mesh, edge_tile=None)))):
        meshes.append(batch.mesh)
        state = stage.init_state(device="cpu")
        state.model.load_state_dict(W.flax_to_state_dict(params), strict=True)
        tgcu.fused_edge_mlp_trainable = record
        try:
            outputs = state.model(batch.mesh, batch.points, train=True, train_vismask=True)
        finally:
            tgcu.fused_edge_mlp_trainable = trainable
        total, metrics = stage._losses(outputs, batch, True)
        total.backward()
        grads[name] = ({n: p.grad.clone() for n, p in state.model.named_parameters()},
                       {k: float(v.detach()) for k, v in metrics.items()})
    return dict(jmetrics=jmetrics, jgrads=W.flax_to_state_dict(jgrads), grads=grads, calls=calls,
                revs=revs, meshes=meshes)


def test_windowed_corr_step_matches_jax(windowed_step):
    """Every edge layer of the step took the K5 trainable (tile 128; 8 of
    them); the losses at NETWORK and every gradient at GRAD relative to its
    magnitude, the whole gradient vector at GRAD_TOTAL (the tolerances of
    the full-table step, test_torch_train, with their reasons)."""
    assert windowed_step["calls"][:8] == [128] * 8
    grads, metrics = windowed_step["grads"]["windowed"]
    for k in ("corr_loss", "vis_loss", "total_loss"):
        ref = float(windowed_step["jmetrics"][k])
        assert abs(metrics[k] - ref) <= NETWORK[0] * abs(ref), (k, metrics[k], ref)
    ref = windowed_step["jgrads"]
    assert set(grads) == set(ref)
    for n, g in grads.items():
        assert_rel_close(g, ref[n], GRAD, what=n)
    flat = np.concatenate([F.np_(grads[n]).ravel() for n in grads])
    flat_ref = np.concatenate([np.asarray(ref[n]).ravel() for n in grads])
    assert np.linalg.norm(flat - flat_ref) <= GRAD_TOTAL * np.linalg.norm(flat_ref)


def test_windowed_corr_step_is_the_full_table_step(windowed_step):
    """On local tables K5 computes K1's function: the step with the batch's
    edge tile and the step on the full table give the same losses and
    gradients bit for bit (plain versions on the CPU, one thread)."""
    (gw, mw), (gf, mf) = windowed_step["grads"]["windowed"], windowed_step["grads"]["full"]
    assert windowed_step["calls"][8:] == [None] * 8
    assert mw == mf
    for n in gw:
        assert torch.equal(gw[n], gf[n]), n


def test_training_edge_calls_take_the_batch_reverse_tables(windowed_step):
    """Each training edge call of the step gets, for K6's db_table, the
    reverse table its batch holds for that table (`MeshBatch.tpl_rev` /
    `geo_rev`, built once per batch: 8 calls per batch share two tables),
    and that table is `reverse_table` of the batch's neighbour table."""
    revs = windowed_step["revs"]
    assert len(revs) == 16
    for i, mesh in enumerate(windowed_step["meshes"]):
        tables = (mesh.tpl_rev, mesh.geo_rev)
        assert all(any(r is t for t in tables) for r in revs[8 * i:8 * i + 8])
        assert {id(r) for r in revs[8 * i:8 * i + 8]} == {id(t) for t in tables}
        V = mesh.tpl_nbr.shape[1]
        for (order, offsets), nbr, mask in ((mesh.tpl_rev, mesh.tpl_nbr, mesh.tpl_mask),
                                            (mesh.geo_rev, mesh.geo_nbr, mesh.geo_mask)):
            ref = tgf.reverse_table(nbr, V, mask)
            assert torch.equal(order, ref[0]) and torch.equal(offsets, ref[1])


# ---------------------------------------------------------------------------
# the datasets' edge_tile and the CLI's --edge-impl
# ---------------------------------------------------------------------------

def rcm_ordered(model: RigModel) -> RigModel:
    """`model` with its vertices in reverse Cuthill-McKee order
    (`data.preprocess.rcm_vertex_order`), every per-vertex array permuted
    with them."""
    order = tpre.rcm_vertex_order(len(model.verts), model.tpl_edges, model.geo_edges)
    verts, tpl, geo, *rows = tpre.apply_vertex_order(
        order, model.verts, model.tpl_edges, model.geo_edges, model.gt_flow, model.pred_flow,
        model.attn, model.skin_input, model.skin_label, model.skin_nn, model.loss_mask,
        model.rig.skins)
    return dataclasses.replace(
        model, verts=verts, tpl_edges=tpl, geo_edges=geo,
        rig=dataclasses.replace(model.rig, skins=rows[-1]),
        **dict(zip(("gt_flow", "pred_flow", "attn", "skin_input", "skin_label", "skin_nn",
                    "loss_mask"), rows[:-1])))


def test_datasets_stack_a_tile_only_where_local():
    """The rig dataset's batches carry edge_tile only where every table is
    local at it: the creatures as generated are not (the tile is dropped,
    K1 trains them), the same small creatures in RCM order (`rcm_ordered`
    above: every per-vertex array permuted with the vertices) are; nothing
    is reordered by default."""
    ds = tcr.creature_rig_dataset(num_models=2, seed=0, num_points=64, target_verts=600,
                                  device="cpu")
    ds.edge_tile = 128
    assert ds.batch([0, 1], device="cpu").mesh.edge_tile is None
    assert tgcu.auto_select_edge_impl(ds._mesh_cache, 128) == "fused"
    models = [rcm_ordered(m) for m in ds.models]
    m, r = ds.models[0], models[0]
    order = tpre.rcm_vertex_order(len(m.verts), m.tpl_edges, m.geo_edges)
    np.testing.assert_array_equal(r.verts, m.verts[order])
    np.testing.assert_array_equal(r.rig.skins, m.rig.skins[order])
    np.testing.assert_array_equal(r.skin_nn, m.skin_nn[order])
    rcm = RigDataset(models, edge_tile=128)
    assert rcm.batch([0, 1], device="cpu").mesh.edge_tile == 128
    assert RigDataset(models).batch([0], device="cpu").mesh.edge_tile is None


def test_cli_train_edge_impl_windowed(tmp_path, monkeypatch):
    """`train corr_pose --edge-impl windowed` on capsules whose tables are
    local (V=258 in the 512 bucket, four tiles): every training edge call
    takes the tile; `--edge-impl fused` (the default) none."""
    seen = []
    trainable = tgcu.fused_edge_mlp_trainable

    def record(*args, **kw):
        seen.append(kw.get("tile_v"))
        return trainable(*args, **kw)

    monkeypatch.setattr(tgcu, "fused_edge_mlp_trainable", record)
    argv = ["train", "corr_pose", "--data", "capsule", "--num-models", "1", "--fixture-points",
            "64", "--fixture-lat", "17", "--fixture-lon", "16", "--batch-size", "1",
            "--epochs", "1", "--device", "cpu", "--checkpoint", str(tmp_path / "c"),
            "--logdir", str(tmp_path / "l")]
    tcli.main(argv + ["--edge-impl", "windowed"])
    assert seen and set(seen) == {tcli.EDGE_TILE}
    seen.clear()
    tcli.main(argv)
    assert seen and set(seen) == {None}
