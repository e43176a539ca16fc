"""The port's kernel functions (K1 edge MLP, K2 kNN + gather, K3 row gather,
K4 kNN, K5 windowed edge MLP) against the JAX package's Pallas kernels, run
in interpret mode on the CPU; the layouts the wgmma kernels read (K1/K5's
W2, K6's dW2 scratch tiles and dh operand) written out on the CPU, and
K6's dW2 plain version against the plain backward's dW2.

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


def _edge_inputs(H, seed, V=V, D=D):
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


@pytest.mark.parametrize("H,Vn,Dn", [(16, V, D), (32, V, D), (64, V, D), (128, V, D),
                                     (256, V, D), (32, 100, 16)])
def test_edge_mlp_matches_pallas_interpret(H, Vn, Dn):
    """K1 plain vs the Pallas kernel (interpret) and its bf16 XLA oracle, at
    every width, and at D=16 with V=100 (not a multiple of K1's 64-vertex
    unit on the card; one tile of 100 on the TPU).  Tolerance 2e-2 absolute
    on O(1) LayerNorm outputs: both sides round the LN1 output to bf16
    before the W2 product, from fp32 values computed in another order (and,
    at 128 and above, with the two-pass variance), so a rare element rounds
    one bf16 ulp apart; the mean error stays below 1e-4."""
    a, b, nbr, mask, w2, vecs = _edge_inputs(H, seed=H + Dn - D, V=Vn, D=Dn)
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


@pytest.mark.parametrize("H,Vw,leave,padded", [(16, 48, False, False), (64, 64, True, False),
                                               (32, 64, False, True)])
def test_edge_mlp_windowed_matches_pallas_interpret(H, Vw, leave, padded):
    """K5 plain vs the windowed Pallas kernel (interpret) at TV=16 and V=48
    (three tiles: every window is the whole table, so K5 equals K1) or V=64,
    where with `leave` some neighbours lie outside their window and read a
    zero row on both sides.  With `padded` (D=12, as every case) the last
    tile is all padding (no valid edge) and a vertex's valid slots stop at
    d=2, the shapes the kernel's dead-slab and dead-unit skips meet.
    Tolerances as for K1."""
    rng = np.random.default_rng(H)
    TV = 16
    a, b, _, mask, w2, vecs = _edge_inputs(H, seed=H + 1)
    a, b, mask = a[:, :Vw], b[:, :Vw], mask[:, :Vw]
    nbr = _local_nbr(rng, Vw, TV, leave)
    mask[0, :TV, 3] = mask[1, -TV:, 4] = True
    if padded:
        mask[:, -TV:] = False
        mask[0, 20] = np.arange(D) < 3
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
    if padded:
        assert (got[:, -TV:] == 0).all() and (got[0, 20] != 0).any()


@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_wgmma_w2_layout_matches_fragment_order(H):
    """K5's product on the card, written out on the CPU: each thread's A
    registers hold its quad lane's LN1 columns, in pieces of P = 8 (4 at
    H=16) interleaved across the quad, at wgmma's k positions
    (csrc/wgmma.cuh, csrc/edge_wgmma.cuh), and the B operand is
    read from `wgmma_w2_layout`'s bytes through the descriptor's strides
    (16 H bytes between the two 8-k groups of a chunk, 128 between 8-column
    core matrices, 32 H per 16-k chunk, 16 per output column of the start).
    The sum over physical k must be h @ W2 for both column halves."""
    rng = np.random.default_rng(H)
    h = rng.standard_normal((64, H)).astype(np.float32)
    w2 = rng.standard_normal((H, H)).astype(np.float32)
    lay = tef.wgmma_w2_layout(torch.as_tensor(w2)).float().numpy()       # flat bf16
    P = min(H // 4, 8)
    a_phys = np.full((64, H), np.nan, np.float32)
    for w in range(4):
        for lane in range(32):
            q, r = lane % 4, 16 * w + lane // 4
            for p in range(H // 4 // P):              # lane q's pieces of each row
                for e in range(P):
                    c, j = p * (P // 4) + e // 4, e % 4
                    k = 16 * c + 2 * q + j % 2 + 8 * (j // 2)
                    for row in (r, r + 8):
                        a_phys[row, k] = h[row, (4 * p + q) * P + e]
    assert not np.isnan(a_phys).any()
    for n0, nw in ((0, H), (0, H // 2), (H // 2, H // 2)):
        b_phys = np.empty((H, nw), np.float32)
        for k in range(H):
            c, kk, kin = k // 16, (k % 16) // 8, k % 8
            for n in range(nw):
                byte = c * 32 * H + n0 * 16 + kk * 16 * H + (n // 8) * 128 + (n % 8) * 16 + kin * 2
                b_phys[k, n] = lay[byte // 2]
        w2_16 = torch.as_tensor(w2).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(a_phys @ b_phys, h @ w2_16[:, n0:n0 + nw], rtol=1e-5,
                                   atol=1e-4)


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_dw2_scratch_layout_matches_descriptor_reads(H):
    """K6's dW2 kernel (csrc/edge_mlp_bwd.cu `edge_mlp_dw2_kernel`) written
    out on the CPU over one `pack_dw2_scratch` tile: block slab s copies
    chunk (g, 64 s + c) of the h part to stage chunk g * MW + c (MW = min(H,
    64)); warp w's ldmatrix reads, for k-chunk c, matrix j = lane / 8 at
    stage chunk (2c + j // 2) * MW + 16 w + 8 (j % 2) + row, which gives A =
    h^T (rows of the slab, k = the step's rows); B = ds is read through the
    descriptor (start 16 (2c H + n0) bytes into the ds part, 16 H bytes
    between the two 8-k groups, 128 between 8-column core matrices).  A @ B
    must be the slab's rows of h^T ds."""
    rng = np.random.default_rng(H)
    h = _bf16(rng.standard_normal((64, H)).astype(np.float32))
    ds = _bf16(rng.standard_normal((64, H)).astype(np.float32))
    tile = tef.pack_dw2_scratch(torch.as_tensor(h)[None], torch.as_tensor(ds)[None])
    tile = tile.float().numpy().reshape(2, 64 * H)
    hpart, dspart = tile[0].reshape(8 * H, 8), tile[1]
    MW, NW = min(H, 64), min(H, 128)
    for s in range(max(1, H // 64)):
        stage = np.stack([hpart[(e // MW) * H + s * 64 + e % MW] for e in range(8 * MW)])
        A = np.zeros((64, 64), np.float32)
        for w in range(MW // 16):
            for c in range(4):
                for j in range(4):
                    for row in range(8):
                        chunk = (2 * c + j // 2) * MW + 16 * w + 8 * (j % 2) + row
                        A[16 * w + 8 * (j % 2) + row, 16 * c + 8 * (j // 2):][:8] = stage[chunk]
        for n0 in range(0, H, NW):
            B = np.empty((64, NW), np.float32)
            for k in range(64):
                c, kk, kin = k // 16, (k % 16) // 8, k % 8
                for n in range(NW):
                    byte = (2 * c * H + n0) * 16 + kk * 16 * H + (n // 8) * 128 + (n % 8) * 16 + kin * 2
                    B[k, n] = dspart[byte // 2]
            ref = h.T @ ds
            np.testing.assert_allclose((A @ B)[:MW], ref[64 * s:64 * s + MW, n0:n0 + NW],
                                       rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_dh_operand_layout_matches_descriptor_reads(H):
    """K6's dh^T = W2 ds^T written out on the CPU: A = W2's rows by ldmatrix
    from the row-major staging (warp w of slab s, k-chunk c: lane l gives row
    64 s + 16 w + 8 (l / 8 % 2) + l % 8, column 16 c + 8 (l / 16)), B = ds
    placed by `dh_operand_index` and read through the descriptor (start 128
    (16 c + n0 / 8) bytes, 1024 between the two 8-k groups, 128 between
    8-row core matrices), for each warpgroup's edge rows n0 .. n0 + N - 1
    (N = 64 at H >= 128, else 32)."""
    rng = np.random.default_rng(H + 1)
    w2 = _bf16(rng.standard_normal((H, H)).astype(np.float32))
    ds = _bf16(rng.standard_normal((64, H)).astype(np.float32))
    dsb = np.zeros(64 * H, np.float32)
    dsb[tef.dh_operand_index(H).numpy().reshape(-1)] = ds.reshape(-1)
    assert sorted(tef.dh_operand_index(H).numpy().reshape(-1)) == list(range(64 * H))
    N = 64 if H >= 128 else 32
    rows = 64 * max(1, H // 64)
    A = np.zeros((rows, H), np.float32)
    for s in range(max(1, H // 64)):
        for w in range(4):
            if 64 * s + 16 * w >= H:
                continue
            for c in range(H // 16):
                for lane in range(32):
                    r = 64 * s + 16 * w + 8 * (lane // 8 % 2) + lane % 8
                    col = 16 * c + 8 * (lane // 16)
                    A[r, col:col + 8] = w2[r, col:col + 8]
    for n0 in range(0, 64, N):
        B = np.empty((H, N), np.float32)
        for k in range(H):
            c, kk, kin = k // 16, (k % 16) // 8, k % 8
            for n in range(N):
                byte = (16 * c + n0 // 8) * 128 + kk * 1024 + (n // 8) * 128 + (n % 8) * 16 + kin * 2
                B[k, n] = dsb[byte // 2]
        np.testing.assert_allclose((A @ B)[:H], (ds @ w2.T).T[:, n0:n0 + N], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_dw2_plain_over_packed_scratch_is_the_plain_backward_dw2(H):
    """K6's dW2 kernel's plain version over the scratch tiles packed from
    the plain backward's own h and ds (`bwd_step_tiles`: the tiles the
    main kernel writes) equals `edge_mlp_bwd_plain`'s dW2,
    with whole dead steps (vertices 40-99 have no valid edge) and a ragged
    last step (V=128 is not a multiple of 64 // 12 = 5): the same fp32 sums
    of bf16 products in another order, 1e-5 of the largest entry."""
    a, b, nbr, mask, w2, vecs = _edge_inputs(H, seed=H + 7)
    mask[0, 40:100] = False
    t = torch.as_tensor
    args = (t(a).to(torch.bfloat16), t(b).to(torch.bfloat16), t(nbr).long(), t(mask), t(w2),
            *map(t, vecs))
    dout = t(np.random.default_rng(H).standard_normal((B, V, H)).astype(np.float32))
    tiles, live = tef.bwd_step_tiles(*args, dout)
    assert tiles.shape == (B * 26, 128 * H) and live.shape == (B * 26,)
    assert live.sum() <= B * 26 - 12                                 # whole dead steps
    ref = tef.edge_mlp_bwd_plain(*args, dout)[2]
    got = tef.fused_edge_mlp_dw2(tiles, live)
    assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), what="dw2")


def test_edge_wrapper_on_cpu_is_the_plain_version():
    a, b, nbr, mask, w2, vecs = _edge_inputs(32, seed=1)
    t = torch.as_tensor
    args = (t(a).to(torch.bfloat16), t(b).to(torch.bfloat16), t(nbr).long(), t(mask),
            t(w2), *map(t, vecs))
    dout = t(np.random.default_rng(2).standard_normal((B, V, 32)).astype(np.float32))
    before = (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches)
    assert torch.equal(tef.fused_edge_mlp(*args), tef.edge_mlp_plain(*args))
    # K6's forward for the route's invariant is, on the CPU, the plain forward
    grads, fwd = tef.fused_edge_mlp_bwd(*args, dout, return_forward=True)
    assert torch.equal(fwd, tef.edge_mlp_plain(*args))
    for g, r in zip(grads, tef.edge_mlp_bwd_plain(*args, dout)):
        assert torch.equal(g, r)
    assert (tef.fused_edge_mlp.launches, tef.fused_edge_mlp_bwd.launches) == before


def test_dw2_wrapper_on_cpu_is_the_plain_version():
    """On CPU tiles K6's dW2 wrapper is its plain version and launches
    nothing; a dead step's tile is not read (NaN there changes nothing)."""
    rng = np.random.default_rng(3)
    h, ds = (torch.as_tensor(rng.standard_normal((5, 64, 32)).astype(np.float32))
             for _ in range(2))
    scratch = tef.pack_dw2_scratch(h, ds)
    live = torch.tensor([True, False, True, True, False])
    ref = tef.edge_mlp_dw2_plain(scratch, live)
    scratch[~live] = float("nan")
    before = tef.fused_edge_mlp_dw2.launches
    assert torch.equal(tef.fused_edge_mlp_dw2(scratch, live), ref)
    assert tef.fused_edge_mlp_dw2.launches == before
    h16, ds16 = (x.to(torch.bfloat16).float()[live] for x in (h, ds))
    assert_close(ref, torch.einsum("tri,tro->io", h16, ds16), atol=1e-4, what="dw2")


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


@pytest.mark.parametrize("k", [1, 2, 5, 8])
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
    if k >= 5:
        assert (idx.numpy()[1, :, 3:] == 0).all() and (score.numpy()[1, :, 3:] < -1e29).all()
        assert idx.numpy()[0, 3, 0] == 17


@pytest.mark.parametrize("k", [1, 2, 5, 8])
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


@pytest.mark.parametrize("gather", [False, True])
def test_knn_exact_ties_match_pallas_interpret(gather):
    """12 copies of one candidate (columns one thread of the card kernel
    holds as a pair, other lanes of its quad, later tiles) and queries equal
    to it: the plain version and the Pallas kernel both pick the five
    smallest columns, with equal scores."""
    ties = [2, 3, 4, 9, 70, 100, 101, 120, 121, 122, 126, 127]
    q, c, mask, values = _knn_inputs(seed=21)
    c[0, ties] = c[0, 2]
    q[0, [0, 31, 63]] = c[0, 2]
    mask[0, ties] = True
    t = torch.as_tensor
    if gather:
        idx, score, _ = tkf.knn_batched(t(q), t(c), 5, t(mask), gather_values=t(values))
        jidx, jscore, _ = jax_knn_batched(jnp.asarray(q), jnp.asarray(c), 5, jnp.asarray(mask),
                                          gather_values=jnp.asarray(values), interpret=True)
    else:
        idx, score = tkf.knn_batched(t(q), t(c), 5, t(mask))
        jidx, jscore = jkf._fused_raw(jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask), 5,
                                      interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert_close(score, jscore, atol=1e-5, what="score")
    for n in (0, 31, 63):
        np.testing.assert_array_equal(idx.numpy()[0, n], ties[:5])
        assert (score.numpy()[0, n] == score.numpy()[0, n, 0]).all()


def test_knn_all_masked_returns_slot_zero():
    q, c, _, values = _knn_inputs(seed=7)
    t = torch.as_tensor
    mask = torch.zeros(B, c.shape[1], dtype=torch.bool)
    idx, score, gathered = tkf.knn_batched(t(q), t(c), 3, mask, gather_values=t(values))
    assert (idx == 0).all() and (score < -1e29).all()
    assert torch.equal(gathered, t(values)[:, :1, None, :].expand_as(gathered))


@pytest.mark.parametrize("C", [3, 4, 64, 67])
def test_gather_rows_matches_pallas_interpret(C):
    """K3 plain vs the Pallas one-hot gather (interpret), one width of each
    of the kernel's row classes (3: a thread per row; 4 and 64: 16-byte
    vectors; 67: a warp per row of 4-byte elements): the port is exact, the
    TPU kernel ~2^-17 relative (hi/lo bf16 halves), so 2e-5 relative."""
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
    """Import every module of morig_tpu_torch with jax, flax, optax, msgpack
    and the JAX package blocked, build the six networks on the CPU and run
    the batched rig DAG, the single-mesh DAG and a tracker (one frame, a few
    IK iterations), take one step of the deform, rig, skin, bone and root
    training stages at a tiny size and build `capsule_predictor` with one
    training step: the port stands on its own."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        BLOCKED = ("jax", "flax", "optax", "msgpack", "morig_tpu")
        for name in BLOCKED:
            sys.modules[name] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        import morig_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(morig_tpu_torch.__path__, "morig_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        assert {"morig_tpu_torch.nn.norm", "morig_tpu_torch.eval.torch_import"} <= set(mods)
        from morig_tpu_torch.data.synthetic import capsule_batch
        from morig_tpu_torch.pipelines.rig_predict import RigPredictor
        entries, frames = capsule_batch(1, 5, 64, 64, n_lat=7, n_lon=6)
        pred = RigPredictor.random(0, device="cpu")
        rigs = pred.predict_rig_batch(entries, frames)
        assert len(rigs) == 1 and np.isfinite(rigs[0].pos).all()
        rig = pred.predict_rig(entries[0], frames[0])
        assert np.isfinite(rig.pos).all()
        from morig_tpu_torch.core.config import TrackingConfig
        from morig_tpu_torch.pipelines.tracking import Tracker
        vm = entries[0]["vert_mask"]
        traj, vis, quats = Tracker(pred.deform, rig, entries[0], TrackingConfig(2, 2)).run(
            entries[0]["verts"][vm], np.transpose(frames[0][:2], (1, 0, 2)))
        assert traj.shape == (vm.sum(), 1, 3) and np.isfinite(quats).all()
        import dataclasses
        from morig_tpu_torch.core.config import DEFAULT_CONFIG
        from morig_tpu_torch.data.pose import PoseDataset, capsule_pose_dataset
        from morig_tpu_torch.data.rig import capsule_rig_dataset
        from morig_tpu_torch.train import stages
        cfg = dataclasses.replace(DEFAULT_CONFIG, model=dataclasses.replace(
            DEFAULT_CONFIG.model, num_keyframes=2))
        rb = capsule_rig_dataset(1, num_keyframes=2, n_lat=7, n_lon=6, num_points=64).batch(
            [0], device="cpu")
        pds = capsule_pose_dataset(num_models=1, num_frames=3, num_points=64, n_lat=7, n_lon=6)
        pb = PoseDataset(pds.models, buckets=(64,)).batch([0], 0, 2, device="cpu")
        for stage, b in ((stages.DeformPoseStage(cfg), pb),
                         (stages.RigStage(cfg, num_embed_sample=32, width_scale=0.25), rb),
                         (stages.SkinStage(cfg, num_embed_sample=32, width_scale=0.25), rb)):
            m = stage.train_step(stage.init_state(device="cpu"), b)
            assert np.isfinite(m["total_loss"]) and np.isfinite(m["grad_norm"])
        from morig_tpu_torch.data.skeleton_data import capsule_skel_dataset
        sb = capsule_skel_dataset(1, max_joints=6, n_lat=7, n_lon=6, num_points=64, device="cpu")
        for stage in (stages.BoneStage(), stages.RootStage()):
            m = stage.train_step(stage.init_state(device="cpu"), sb)
            assert np.isfinite(m["total_loss"]) and np.isfinite(m["grad_norm"])
        from morig_tpu_torch.pipelines.rig_predict import capsule_predictor
        pred, pose_ds, rig_ds = capsule_predictor(train_steps=1, device="cpu")
        assert isinstance(pred, RigPredictor) and len(pose_ds) == len(rig_ds) == 2
        assert not any(k.split(".")[0] in BLOCKED for k, v in sys.modules.items() if v is not None)
        print(len(mods), "modules")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split()[0]) >= 20
