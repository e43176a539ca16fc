"""The launch planner of the ordered row scatter KS
(`morig_tpu_torch.kernels.gather_fused.plan_scatter`) and the scatter's
plain routes, on the CPU: the route, group width and rows per warp of every
shape phase 3 and the card tests use, groups that cover each channel of each
target row once, grids that cover the target rows, the group widths the
kernel instantiates; the plain version of one launch over a reverse table,
and K2's backward over one shared table.  The kernel itself runs on the card
only (tests/test_torch_cuda.py, marked gpu).

    python -m pytest tests/test_torch_scatter_plan.py -q
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from morig_tpu_torch.kernels import gather_fused as gf
from morig_tpu_torch.kernels import knn_fused as kf

SMS = (132, 114, 16)          # H100 SXM, H100 PCIe, a small card
F32, BF16 = 4, 2

# (R, C, element size, aligned) -> (route, vec, group, rows per warp, passes):
# phase 3's five shapes (K2's vismask backward, 64 fp32 wide, into 4 x 1024
# points; K6's db_table over 4 x 2048 vertices at H = 16, 32, 128, 256, bf16),
# K2's completion gather (3 wide), the card tests' widths and an unaligned
# base
PATH_PLANS = {
    (4096, 64, F32, True): ("vector", 4, 16, 2, 1),
    (8192, 16, BF16, True): ("vector", 8, 2, 16, 1),
    (8192, 32, BF16, True): ("vector", 8, 4, 8, 1),
    (8192, 128, BF16, True): ("vector", 8, 16, 2, 1),
    (8192, 256, BF16, True): ("vector", 8, 32, 1, 1),
    (1200, 3, F32, True): ("scalar", 1, 4, 8, 1),
    (480, 3, BF16, True): ("scalar", 1, 4, 8, 1),
    (480, 16, F32, True): ("vector", 4, 4, 8, 1),
    (480, 32, F32, True): ("vector", 4, 8, 4, 1),
    (480, 128, F32, True): ("vector", 4, 32, 1, 1),
    (480, 256, F32, True): ("vector", 4, 32, 1, 2),
    (480, 64, BF16, True): ("vector", 8, 8, 4, 1),
    (480, 64, F32, False): ("scalar", 1, 32, 1, 2),
    (480, 128, BF16, False): ("scalar", 1, 32, 1, 4),
    (480, 12, BF16, True): ("scalar", 1, 16, 2, 1),
}


@pytest.mark.parametrize("shape", list(PATH_PLANS), ids=lambda s: "R{}-C{}-e{}-{}".format(*s))
def test_plan_of_the_paths_shapes(shape):
    """The route, vector width, group, rows per warp and passes of each
    shape of phase 3 and the card tests, on the H100's 132 SMs."""
    p = gf.plan_scatter(*shape, 132)
    assert (p.route, p.vec, p.group, p.rows_per_warp, p.passes) == PATH_PLANS[shape]


CS = (1, 2, 3, 4, 7, 8, 12, 16, 24, 32, 40, 64, 100, 128, 256, 264, 512, 1000)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("R", (0, 1, 31, 300, 4096, 8192, 100_000))
def test_plan_of_a_shape(R, sms):
    """For every width, element size and alignment: the vector route
    exactly where a row is whole 16-byte vectors on an aligned base; a
    group the smallest power of two, at most a warp, that covers the row's
    vectors, wider rows in passes that cover it once; a block of 64 to 256
    threads, the largest that gives MIN_BLOCKS_PER_SM blocks per SM where
    one does; a grid with one group per target row and no empty block."""
    for C, size, aligned in itertools.product(CS, (F32, BF16), (True, False)):
        p = gf.plan_scatter(R, C, size, aligned, sms)
        vector = aligned and C * size % 16 == 0
        assert p.route == ("vector" if vector else "scalar")
        assert p.vec == (16 // size if vector else 1)
        lanes = C // p.vec
        assert p.group & (p.group - 1) == 0 and 1 <= p.group <= 32
        assert p.group == 32 or p.group >= lanes > p.group // 2 or lanes == 1 == p.group
        assert p.rows_per_warp * p.group == 32
        assert (p.passes - 1) * p.group < lanes <= p.passes * p.group
        assert p.threads in gf.THREADS
        groups = R * p.group
        assert p.grid * p.threads >= groups > (p.grid - 1) * p.threads or R == p.grid == 0
        bigger = [t for t in gf.THREADS if t > p.threads]
        assert all(-(-groups // t) < gf.MIN_BLOCKS_PER_SM * sms for t in bigger)
        assert p.threads == 64 or p.grid >= gf.MIN_BLOCKS_PER_SM * sms


def _lane_channels(p, C):
    """The kernel's map, written out: for each global thread of the launch,
    (target row, the channels it sums), as scatter_rows_in_order computes it
    from blockIdx, threadIdx and the plan."""
    out = []
    for tid in range(p.grid * p.threads):
        r, gl = tid // p.group, tid % p.group
        for q in range(p.passes):
            v = q * p.group + gl
            if v < C // p.vec:
                out.append((r, tid, tuple(range(v * p.vec, (v + 1) * p.vec))))
    return out


@pytest.mark.parametrize("C, size, aligned, R, sms", [
    (3, F32, True, 37, 2), (64, F32, True, 37, 2), (16, BF16, True, 37, 2),
    (256, BF16, True, 37, 2), (256, F32, True, 37, 2), (64, F32, False, 37, 2),
    (40, BF16, True, 37, 2), (12, BF16, True, 131, 1), (128, BF16, True, 131, 1)])
def test_each_channel_is_summed_by_one_lane(C, size, aligned, R, sms):
    """Every channel of every target row below R is summed by exactly one
    lane, the lanes of a row lie in one warp (their shuffles stay in it),
    and threads past R, which the kernel sends home, own no row below R."""
    p = gf.plan_scatter(R, C, size, aligned, sms)
    seen = {}
    for r, tid, chans in _lane_channels(p, C):
        if r >= R:
            continue
        for c in chans:
            assert (r, c) not in seen
            seen[r, c] = tid
    assert set(seen) == {(r, c) for r in range(R) for c in range(C)}
    for r in range(R):
        assert len({seen[r, c] // 32 for c in range(C)}) == 1


def test_group_widths_are_the_kernels():
    """The planner's group widths are the ones csrc/row_scatter.cu
    instantiates (its `launch_group` cases), and its rows in flight U is
    the one constant the source states."""
    src = (Path(gf.__file__).resolve().parents[1] / "csrc" / "row_scatter.cu").read_text()
    cases = {int(c) for c in re.findall(r"case (\d+): launch<T, VEC, \1>", src)}
    assert cases == {1, 2, 4, 8, 16, 32}
    widths = {gf.plan_scatter(64, C, size, al, 132).group
              for C, size, al in itertools.product(CS, (F32, BF16), (True, False))}
    assert widths == cases
    assert re.findall(r"constexpr int U = (\d+);", src) == ["8"]


def _table_case(seed, masked, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, 12, (3, 40, 2)))      # targets 12-15 get none
    rows = torch.as_tensor(rng.standard_normal((3, 40, 2, 24)).astype(np.float32)).to(dtype)
    mask = torch.as_tensor(rng.random((3, 40, 2)) < 0.7) if masked else None
    return idx, rows, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_row_scatter_plain_over_a_table(masked, dtype):
    """`row_scatter_plain` (one launch's plain version) over a reverse table
    equals `scatter_rows_plain` on the valid rows bit for bit, zeros where a
    target has no source; `row_scatter_launch` on a CPU tensor is it, and
    `scatter_rows` given the table equals `scatter_rows` without it."""
    idx, rows, mask = _table_case(int(masked), masked, dtype)
    order, offsets = gf.reverse_table(idx, 16, mask)
    flat = rows.reshape(-1, rows.shape[-1])
    got = gf.row_scatter_plain(flat, order, offsets, 3 * 16)
    assert got.dtype == torch.float32
    valid = rows if mask is None else rows * mask[..., None]
    assert torch.equal(got.reshape(3, 16, -1), gf.scatter_rows_plain(idx, valid, 16))
    assert not got.reshape(3, 16, -1)[:, 12:].any()
    assert torch.equal(gf.row_scatter_launch(flat, order, offsets, 3 * 16), got)
    if mask is None:
        assert torch.equal(gf.scatter_rows(idx, rows, 16, rev=(order, offsets)),
                           gf.scatter_rows(idx, rows, 16))


def test_knn_backward_shares_one_table(monkeypatch):
    """K2's backward builds one reverse table for its two scatters (the
    candidates' and the values' gradients), and its gradients equal, bit
    for bit, those of the two scatters through `index_add_` it made before
    (`scatter_rows_plain`, each on its own)."""
    rng = np.random.default_rng(23)
    q = torch.as_tensor(rng.standard_normal((2, 48, 16)).astype(np.float32))
    c = torch.as_tensor(rng.standard_normal((2, 20, 16)).astype(np.float32))
    mask = torch.as_tensor(rng.random((2, 20)) < 0.8)
    vals = torch.as_tensor(rng.standard_normal((2, 20, 5)).astype(np.float32))
    ws = torch.as_tensor(rng.standard_normal((2, 48, 3)).astype(np.float32))
    wg = torch.as_tensor(rng.standard_normal((2, 48, 3, 5)).astype(np.float32))
    built = []
    real = kf.reverse_table
    monkeypatch.setattr(kf, "reverse_table", lambda *a, **k: built.append(a) or real(*a, **k))
    tq, tc, tv = (x.clone().requires_grad_() for x in (q, c, vals))
    idx, score, gathered = kf.knn_batched(tq, tc, 3, mask, gather_values=tv)
    ((score * ws).sum() + (gathered * wg).sum()).backward()
    assert len(built) == 1
    bsel = torch.arange(2)[:, None, None]
    dq = torch.einsum("bnk,bnkc->bnc", ws, c[bsel, idx])
    dc = gf.scatter_rows_plain(idx, ws[..., None] * q[:, :, None, :], 20)
    dv = gf.scatter_rows_plain(idx, wg, 20)
    for name, g, r in (("query", tq.grad, dq), ("cand", tc.grad, dc), ("values", tv.grad, dv)):
        assert torch.equal(g, r), name
