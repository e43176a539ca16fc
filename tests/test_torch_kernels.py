"""The port's kernel functions (K1 edge MLP, K2 kNN + gather, K3 row gather,
K4 kNN, K5 windowed edge MLP) against the JAX package's Pallas kernels, run
in interpret mode on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version, which is
what these tests hold against JAX; the CUDA kernels themselves are checked
against the same plain versions on the card by chip_smoke.py.  Also here:
the package imports and runs with jax blocked, and a host without nvcc gets
an error, not a substitute, when it asks for the kernel build.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.kernels import edge_fused as jef
from morig_tpu.kernels import knn_fused as jkf
from morig_tpu.kernels.gather_fused import gather_rows as jax_gather_rows
from morig_tpu.kernels.knn_fused import knn_batched as jax_knn_batched
from morig_tpu_torch.kernels import build as kb
from morig_tpu_torch.kernels import edge_fused as tef
from morig_tpu_torch.kernels import gather_fused as tgf
from morig_tpu_torch.kernels import knn_fused as tkf

from torch_port_fixtures import assert_close

B, V, D = 2, 128, 12


def _edge_inputs(H, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, V, H)).astype(np.float32)
    b = rng.standard_normal((B, V, H)).astype(np.float32)
    nbr = rng.integers(0, V, (B, V, D)).astype(np.int32)
    mask = rng.random((B, V, D)) < 0.7
    mask[:, :, 0] = True
    mask[:, 5] = False                       # rows with no valid edge
    mask[1, 77] = False
    w2 = (rng.standard_normal((H, H)) / np.sqrt(H)).astype(np.float32)
    vecs = [0.1 * rng.standard_normal(H), rng.uniform(0.5, 1.5, H),
            0.1 * rng.standard_normal(H), rng.uniform(0.5, 1.5, H),
            0.1 * rng.standard_normal(H)]
    return a, b, nbr, mask, w2, [v.astype(np.float32) for v in vecs]


def _port_edge(a, b, nbr, mask, w2, vecs):
    t = torch.as_tensor
    return tef.fused_edge_mlp(t(a).to(torch.bfloat16), t(b).to(torch.bfloat16),
                              t(nbr).long(), t(mask), t(w2), *map(t, vecs))


@pytest.mark.parametrize("H", [16, 64, 128])
def test_edge_mlp_matches_pallas_interpret(H):
    """K1 plain vs the Pallas kernel (interpret) and its bf16 XLA oracle.
    Tolerance 2e-2 absolute on O(1) LayerNorm outputs: both sides round the
    LN1 output to bf16 before the W2 product, from fp32 values computed in
    another order (and, at 128, with the two-pass variance), so a rare
    element rounds one bf16 ulp apart; the mean error stays below 1e-4."""
    a, b, nbr, mask, w2, vecs = _edge_inputs(H, seed=H)
    got = _port_edge(a, b, nbr, mask, w2, vecs)
    j = [jnp.asarray(x) for x in (a, b, nbr, mask, w2, *vecs)]
    pallas = jef.fused_edge_mlp_auto(*j, tile_v=128, interpret=True)
    oracle = jef.reference_edge_mlp_bf16(*j)
    for ref, what in ((pallas, "pallas"), (oracle, "oracle")):
        assert_close(got, ref, atol=2e-2, what=what)
        assert np.abs(got.numpy() - np.asarray(ref)).mean() < 1e-4
    assert (got.numpy()[:, 5] == 0).all() and (got.numpy()[1, 77] == 0).all()


def _local_nbr(rng, Vw, TV, leave: bool):
    """(B, Vw, D) tables inside each vertex tile's window, with, if `leave`,
    some valid neighbours outside it (they read a zero row)."""
    v = np.arange(Vw)
    ws = np.clip(v // TV - 1, 0, Vw // TV - 3) * TV
    nbr = ws[None, :, None] + rng.integers(0, 3 * TV, (B, Vw, D))
    nbr[:, :, 0] = v
    if leave:
        nbr[0, :TV, 3] = Vw - 1                  # tile 0 reaches into the last tile
        nbr[1, -TV:, 4] = 0                      # the last tile reaches row 0
    return nbr


@pytest.mark.parametrize("H,Vw,leave", [(16, 48, False), (64, 64, True)])
def test_edge_mlp_windowed_matches_pallas_interpret(H, Vw, leave):
    """K5 plain vs the windowed Pallas kernel (interpret) at TV=16 and V=48
    (three tiles: every window is the whole table, so K5 equals K1) or V=64,
    where with `leave` some neighbours lie outside their window and read a
    zero row on both sides.  Tolerances as for K1."""
    rng = np.random.default_rng(H)
    TV = 16
    a, b, _, mask, w2, vecs = _edge_inputs(H, seed=H + 1)
    a, b, mask = a[:, :Vw], b[:, :Vw], mask[:, :Vw]
    nbr = _local_nbr(rng, Vw, TV, leave)
    mask[0, :TV, 3] = mask[1, -TV:, 4] = True
    t = torch.as_tensor
    args = (t(a).to(torch.bfloat16), t(b).to(torch.bfloat16), t(nbr).long(), t(mask), t(w2),
            *map(t, vecs))
    got = tef.fused_edge_mlp_windowed(*args, tile_v=TV)
    assert torch.equal(got, tef.edge_mlp_windowed_plain(*args, tile_v=TV))
    j = [jnp.asarray(x) for x in (a, b, nbr, mask, w2, *vecs)]
    ref = jef.fused_edge_mlp_auto(*j, windowed=True, tile_v=TV, interpret=True)
    assert_close(got, ref, atol=2e-2, what="windowed")
    assert np.abs(got.numpy() - np.asarray(ref)).mean() < 1e-4
    full = tef.edge_mlp_plain(*args)
    assert jef.check_neighbor_locality(nbr, TV) == tef.check_neighbor_locality(nbr, TV) == (
        not leave)
    if leave:
        assert not torch.equal(got[0, :TV], full[0, :TV])
    else:
        assert torch.equal(got, full)


def test_edge_wrapper_on_cpu_is_the_plain_version():
    a, b, nbr, mask, w2, vecs = _edge_inputs(32, seed=1)
    t = torch.as_tensor
    args = (t(a).to(torch.bfloat16), t(b).to(torch.bfloat16), t(nbr).long(), t(mask),
            t(w2), *map(t, vecs))
    before = tef.fused_edge_mlp.launches
    assert torch.equal(tef.fused_edge_mlp(*args), tef.edge_mlp_plain(*args))
    assert tef.fused_edge_mlp.launches == before


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _knn_inputs(seed, N=64, Pc=128, C=64):
    rng = np.random.default_rng(seed)
    q, c = _unit(rng, (B, N, C)), _unit(rng, (B, Pc, C))
    c[0, 90] = c[0, 17]                       # duplicate candidates: 17 wins
    q[0, 3] = c[0, 17]
    mask = rng.random((B, Pc)) < 0.8
    mask[0, 17] = mask[0, 90] = True
    mask[1, :] = False                        # an all-masked row ...
    mask[1, [10, 40, 41]] = True              # ... then fewer than k=5 valid
    values = rng.standard_normal((B, Pc, 3)).astype(np.float32) * 10
    return q, c, mask, values


@pytest.mark.parametrize("k", [1, 5])
def test_knn_matches_pallas_interpret(k):
    """K2 plain vs the fused Pallas kNN (interpret): identical indices
    (first index wins ties), scores to 1e-5 (fp32 sums of exact bf16
    products in another order), gathered values to 2e-5 relative (the TPU
    kernel rebuilds them from hi/lo bf16 halves, ~2^-17)."""
    q, c, mask, values = _knn_inputs(seed=k)
    t = torch.as_tensor
    idx, score, gathered = tkf.knn_batched(t(q), t(c), k, t(mask), gather_values=t(values))
    jidx, jscore, jgath = jax_knn_batched(jnp.asarray(q), jnp.asarray(c), k, jnp.asarray(mask),
                                          gather_values=jnp.asarray(values), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert_close(score, jscore, atol=1e-5, what="score")
    assert_close(gathered, jgath, atol=1e-6, rtol=2e-5, what="gathered")
    if k == 5:
        assert (idx.numpy()[1, :, 3:] == 0).all() and (score.numpy()[1, :, 3:] < -1e29).all()
        assert idx.numpy()[0, 3, 0] == 17


@pytest.mark.parametrize("k", [1, 5])
def test_knn_without_values_matches_pallas_interpret(k):
    """K4 plain vs the fused Pallas kNN without values (interpret):
    identical indices, scores to 1e-5."""
    q, c, mask, _ = _knn_inputs(seed=10 + k)
    t = torch.as_tensor
    before = tkf.knn_topk.launches
    idx, score = tkf.knn_batched(t(q), t(c), k, t(mask))
    assert tkf.knn_topk.launches == before
    jidx, jscore = jkf._fused_raw(jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask), k,
                                  interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert_close(score, jscore, atol=1e-5, what="score")
    ref_idx, ref_score, _ = tkf.knn_plain(t(q), t(c), k, t(mask), t(c[..., :3]))
    assert torch.equal(idx, ref_idx) and torch.equal(score, ref_score)


def test_knn_all_masked_returns_slot_zero():
    q, c, _, values = _knn_inputs(seed=7)
    t = torch.as_tensor
    mask = torch.zeros(B, c.shape[1], dtype=torch.bool)
    idx, score, gathered = tkf.knn_batched(t(q), t(c), 3, mask, gather_values=t(values))
    assert (idx == 0).all() and (score < -1e29).all()
    assert torch.equal(gathered, t(values)[:, :1, None, :].expand_as(gathered))


@pytest.mark.parametrize("C", [3, 67])
def test_gather_rows_matches_pallas_interpret(C):
    """K3 plain vs the Pallas one-hot gather (interpret): the port is exact,
    the TPU kernel ~2^-17 relative (hi/lo bf16 halves), so 2e-5 relative."""
    rng = np.random.default_rng(C)
    values = (rng.standard_normal((B, 128, C)) * 10).astype(np.float32)
    idx = rng.integers(0, 128, (B, 32, 16)).astype(np.int64)
    got = tgf.gather_rows(torch.as_tensor(values), torch.as_tensor(idx))
    ref = jax_gather_rows(jnp.asarray(values), jnp.asarray(idx, jnp.int32), interpret=True)
    assert_close(got, ref, atol=1e-6, rtol=2e-5)
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(
        values, idx.reshape(B, -1, 1), axis=1).reshape(B, 32, 16, C))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises a clear error and returns nothing."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kb, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kb.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kb.library()
    assert not (tmp_path / "build").exists()


def test_package_runs_with_jax_blocked():
    """Import every module of morig_tpu_torch with jax, flax, optax and the
    JAX package blocked, build the six networks on the CPU and run the rig
    DAG at a tiny size: the port stands on its own."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        BLOCKED = ("jax", "flax", "optax", "morig_tpu")
        for name in BLOCKED:
            sys.modules[name] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        import morig_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(morig_tpu_torch.__path__, "morig_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        from morig_tpu_torch.data.synthetic import capsule_batch
        from morig_tpu_torch.pipelines.rig_predict import RigPredictor
        entries, frames = capsule_batch(1, 5, 64, 64, n_lat=7, n_lon=6)
        rigs = RigPredictor.random(0, device="cpu").predict_rig_batch(entries, frames)
        assert len(rigs) == 1 and np.isfinite(rigs[0].pos).all()
        assert not any(k.split(".")[0] in BLOCKED for k, v in sys.modules.items() if v is not None)
        print(len(mods), "modules")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split()[0]) >= 20
