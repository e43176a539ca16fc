"""The shape planner of the row-invariant fp32 product KG
(`morig_tpu_torch.kernels.gemm.plan`), on the CPU: one chunk of K for every
shape, the split route only where the tiles alone leave SMs idle, chunk
ranges that cover K once and in order, the workspace the plan names, grids
that cover the output, and the routes of phase 3's shapes.  The kernel
itself runs on the card only (tests/test_torch_cuda.py, marked gpu).

    python -m pytest tests/test_torch_gemm_plan.py -q
"""
import itertools
import re
from pathlib import Path

import pytest
import torch

from morig_tpu_torch.kernels import gemm as kg

SMS = (132, 114, 16)          # H100 SXM, H100 PCIe, a small card
# (batch, M, N, K): phase 3's shapes (chip_smoke.py KG_SHAPES) and their
# input gradients, the temporal attention's batched products, ragged ones
SHAPES = [(1, 8192, 512, 512), (1, 8192, 256, 288), (1, 120, 128, 256), (1, 120, 256, 768),
          (1, 4, 1024, 1088), (4, 1, 1, 1024), (4, 1, 1, 2048), (4, 1, 1, 48),
          (1, 8192, 288, 256), (1, 120, 256, 128), (1, 120, 768, 256), (1, 4, 1088, 1024),
          (32768, 6, 6, 16), (32768, 6, 16, 6), (32768, 16, 6, 6), (1, 1, 1, 1),
          (1, 33, 65, 7), (1, 130, 257, 19), (1, 256, 128, 0), (3, 129, 31, 8), (5, 6, 6, 16),
          (2, 200, 300, 1000), (132, 64, 128, 200), (1, 2048, 64, 64), (12, 10, 256, 768),
          (1, 70, 136, 131), (1, 9, 1024, 65), (7, 3, 5, 64), (1, 64, 64, 65)]


def _tiles(p, batch, M, N):
    bm, bn = kg.TILES[p.tile]
    return -(-M // bm) * -(-N // bn) * batch


def _chunk_ranges(p, K):
    """The k ranges the split kernel's blocks own, as gemm_f32_split_kernel
    computes them from the plan."""
    out = []
    for s in range(p.splits):
        c0 = s * p.per
        out.append((c0 * kg.KC, min((c0 + p.per) * kg.KC, K)))
    return out


def test_chunk_is_one_constant_stated_in_the_source():
    """KC is one compile-time constant of csrc/gemm_f32.cu, the planner's
    KC, 64."""
    src = (Path(kg.__file__).resolve().parents[1] / "csrc" / "gemm_f32.cu").read_text()
    assert re.findall(r"constexpr int KC = (\d+);", src) == [str(kg.KC)]
    assert kg.KC == 64


@pytest.mark.parametrize("batch, M, N, K", SHAPES)
@pytest.mark.parametrize("sms", SMS)
def test_plan_of_a_shape(batch, M, N, K, sms):
    """For every shape and card: chunks is ceil(K / KC), whatever the route;
    the tiny route only for matrices of at most TINY elements summing one
    chunk; the split route only where the plan's tiles leave SMs idle, with
    at least one block per SM where its chunks allow; the split's chunk
    ranges cover K once, in order, none empty; the workspace is the split's
    partials; the grid covers the output."""
    p = kg.plan(batch, M, N, K, sms)
    assert p.chunks == -(-K // kg.KC)
    assert p.route in kg.ROUTES
    if p.route == "tiny":
        assert M * N <= kg.TINY and K <= kg.KC and p.workspace == 0
        assert 1 <= p.grid[0] <= 32 * sms
        return
    bm, bn = kg.TILES[p.tile]
    assert p.grid[0] * bn >= N > (p.grid[0] - 1) * bn
    assert p.grid[1] * bm >= M > (p.grid[1] - 1) * bm
    n = _tiles(p, batch, M, N)
    if p.route == "tile":
        assert p.splits == 1 and p.workspace == 0 and p.grid[2] == min(batch, kg.MAX_GRID_Z)
        assert p.tile in (kg.LARGE, kg.LARGE_ONE) or n >= sms or p.chunks <= 1
        return
    assert p.tile not in (kg.LARGE, kg.LARGE_ONE) and n < sms and p.chunks > 1
    assert n * p.splits >= min(sms, n * p.chunks)
    ranges = _chunk_ranges(p, K)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo % kg.KC == 0 for lo, _ in ranges)
    assert p.workspace == 4 * batch * p.chunks * M * N
    assert p.grid[2] == min(batch * p.splits, kg.MAX_GRID_Z)
    assert 1 <= p.fold <= 32 * sms


@pytest.mark.parametrize("K", [0, 1, 63, 64, 65, 128, 131, 1088])
@pytest.mark.parametrize("tile", range(len(kg.TILES)))
def test_forced_split_gives_each_chunk_a_block(K, tile):
    """The split route forced (as the card tests force it): one chunk per
    block, the ranges covering K = 0, K < KC, K = KC and ragged K once and
    in order, the workspace every chunk's partials; the tile route forced:
    one block walks all of K."""
    p = kg.plan(2, 70, 136, K, 132, route="split", tile=tile)
    chunks = -(-K // kg.KC)
    assert (p.route, p.tile, p.chunks, p.splits) == ("split", tile, chunks, chunks)
    assert p.per == (1 if K else 0)
    assert [hi - lo for lo, hi in _chunk_ranges(p, K)] == (
        [kg.KC] * (K // kg.KC) + ([K % kg.KC] if K % kg.KC else []))
    assert p.workspace == 4 * 2 * chunks * 70 * 136
    q = kg.plan(2, 70, 136, K, 132, route="tile", tile=tile)
    assert (q.route, q.tile, q.splits, q.workspace) == ("tile", tile, 1, 0)
    assert kg.plan(2, 70, 136, K, 132, route="tiny").route == "tiny"


@pytest.mark.parametrize("sms", SMS[:2])
def test_phase3_shapes_take_their_routes(sms):
    """On an H100: the 8192-row products (and their n-fast input gradients)
    take the large tile, 8192 x 288 -> 256 included; the 120-row and 4-row
    products and the masked mean's 4 x 1024 sums split over K, the 4 rows
    in the 8-row tile; the 48-slot masked mean and the temporal attention's
    per-vertex products one thread per element."""
    large = [(1, 8192, 512, 512), (1, 8192, 256, 288), (1, 8192, 288, 256)]
    for shape in large:
        p = kg.plan(*shape, sms)
        assert p.route == "tile" and p.tile in (kg.LARGE, kg.LARGE_ONE), shape
        assert kg.TILES[p.tile] == (128, 128), shape
    for shape in [(1, 120, 128, 256), (1, 120, 256, 768), (1, 4, 1024, 1088), (4, 1, 1, 1024)]:
        assert kg.plan(*shape, sms).route == "split", shape
    assert kg.TILES[kg.plan(1, 4, 1024, 1088, sms).tile] == (8, 128)
    for shape in [(4, 1, 1, 48), (32768, 6, 6, 16), (32768, 6, 16, 6), (32768, 16, 6, 6)]:
        assert kg.plan(*shape, sms).route == "tiny", shape


def test_split_only_where_tiles_leave_sms_idle():
    """Over a grid of shapes: a plan splits K exactly where its tile is not
    the large one, its tiles number fewer than the SMs and K has more than
    one chunk; the large tile only where its tiles keep 3/4 of the SMs busy."""
    for batch, M, N, K in itertools.product((1, 3), (1, 8, 30, 64, 65, 500, 4096),
                                            (1, 100, 1024), (0, 64, 65, 700)):
        p = kg.plan(batch, M, N, K, 132)
        if p.route == "tiny":
            continue
        n = _tiles(p, batch, M, N)
        large = p.tile in (kg.LARGE, kg.LARGE_ONE)
        assert (p.route == "split") == (not large and n < 132 and p.chunks > 1)
        if large:
            assert 4 * n >= 3 * 132 and (p.tile == kg.LARGE) == (n > 132)


def test_plan_refuses_unknown_routes():
    with pytest.raises(ValueError):
        kg.plan(1, 8, 8, 8, 132, route="cublas")
    with pytest.raises(ValueError):
        kg.plan(1, 8, 8, 8, 132, tile=len(kg.TILES))


@pytest.mark.parametrize("route", [None, "tiny", "tile", "split"])
def test_cpu_gemm_is_the_plain_product(route):
    """On the CPU every route is `gemm_plain` (torch.matmul, then the bias):
    the port's CPU numerics do not move."""
    g = torch.Generator().manual_seed(7)
    a, b = torch.randn(5, 70, generator=g), torch.randn(70, 9, generator=g)
    bias = torch.randn(9, generator=g)
    assert torch.equal(kg.gemm(a, b, bias, route=route), torch.matmul(a, b) + bias)
