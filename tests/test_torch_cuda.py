"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and one training step on the card against the same step on the CPU.

Marked `gpu`: every test takes the `cuda` fixture, which skips when
torch.cuda.is_available() is false, so on a CPU host they all skip.  On a
machine with a card (and no jax) run them without the jax-importing
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Small shapes with the edge cases the main path can produce: rows with no
valid edge, ragged vertex tiles, for the serving edge kernel K1 partial
64-vertex units, an all-masked mesh, neighbours that all point at the last
row and views that are not 16-byte aligned, and K1 against K5 on local
tables; K6's recomputed forward against K1's output bit for bit (the
invariant its max routing rests on), and the launch counters of the
forward and the backward kept apart; duplicate and masked kNN candidates, rows with fewer valid
candidates than k, for the kNN kernels K2 and K4 ragged query and
candidate counts (partial 64-query slabs and 64-candidate tiles) at every
k from the main path's and both gather widths, exact ties across the
lanes of a quad and across tiles, misaligned views and the paths' shapes,
and for the windowed edge kernel K5
neighbours outside their window (a zero row), a tile of padding and a unit
with dead upper slabs at every width, in both of its routes (window staged
in shared memory at H <= 128, rows gathered per slab at H = 256), the row
gather K3 at every row class and the main path's shapes, and for the edge
backward K6 exact ties in the max (a
duplicated neighbour column), rows with no valid edge, whole dead steps, an
all-masked batch and ragged last steps, and K6's dW2 kernel alone at 1, 2
and its grid +- 1 live tiles; K1 and K6 at each edge layer of a real
GCUMotion on degree-16 creature tables, with the dout its backward
received (the motion training stages' widths); a BoneStage and a RootStage
step on the card against the same step on the CPU; in the "batch" norm
mode, MaskedBatchNorm and a GCU on the card against the CPU, a
predict_rig_batch call that launches no edge kernel, and a DeformPoseStage
step whose frozen extractor keeps its running statistics bit for bit;
epoch-scanned training (train/scanned.py), its CUDA-graph replays against
the loop bit for bit, and a capture that fails raising; the row-invariant
product KG against the float64 product, every route and tile its planner
can be forced to against the planned call bit for bit (K at the chunk's
edges), halves of its rows and columns against the whole call, and a
split-route call replayed from a CUDA graph; the narrow layers' fp32 tail
KN and KNB at every width it takes against their plain versions (exact
ties, KNB's recomputed forward against KN's output bit for bit, repeats,
batch rows alone against the whole batch, a CUDA-graph replay) and the
narrow route against the same call on the CPU where the routing cannot
differ.  Shapes and types a kernel
does not take raise on a CUDA tensor instead of falling back.
"""
import math

import pytest
import torch

from morig_tpu_torch.kernels import edge_fused as ef
from morig_tpu_torch.kernels import gather_fused as gf
from morig_tpu_torch.kernels import knn_fused as kf

pytestmark = pytest.mark.gpu

# K1: both sides round the LN1 output to bf16 from fp32 values summed in
# another order, so a rare element lands one bf16 ulp apart and moves an
# O(1) output by up to ~2e-2; the mean error stays at fp32 level (below
# 7e-7 at the main path's shapes on the H100).
K1_TOL, K1_MEAN_TOL = 3e-2, 1e-5
K2_TOL = 1e-5      # fp32 sums of exact bf16 products, in another order
# K6 against its plain version (the rule and reasons of chip_smoke.py's
# K6 check).  Both round h, ds and dx to bf16 from fp32 values summed in
# another order, so a rare element lands one bf16 ulp apart; at a near-tie
# of the max that flips the route, which moves one column of dW2, one entry
# of each H2-wide vector gradient and one vertex's rows of da and db_table,
# and the vector gradients and dW2 add up such flips over every edge.  So
# every gradient is held by its relative L2 error, and da and db_table also
# entry by entry.
K6_L2_TOL, K6_ELEM_TOL, K6_FRAC_TOL = 1e-2, 1e-3, 1e-3
K6_NAMES = ("da", "db_table", "dw2", "db2", "dg1", "dbe1", "dg2", "dbe2")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _edge_args(dev, H, B=2, V=301, D=12, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(B, V, H, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(B, V, H, device=dev, generator=g).to(torch.bfloat16)
    nbr = torch.randint(0, V, (B, V, D), device=dev, generator=g)
    mask = torch.rand(B, V, D, device=dev, generator=g) < 0.7
    mask[:, 7] = False                          # vertices with no valid edge
    mask[1, V - 1] = False
    w2 = torch.randn(H, H, device=dev, generator=g) / math.sqrt(H)
    vecs = [0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g)]
    return a, b, nbr, mask, w2, *vecs


@pytest.mark.parametrize("D", [4, 12, 16])
@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_edge_mlp_kernel_matches_plain(cuda, H, D):
    args = _edge_args(cuda, H, D=D, seed=H + D)
    before = ef.fused_edge_mlp.launches
    got = ef.fused_edge_mlp(*args)
    ref = ef.edge_mlp_plain(*args)
    torch.cuda.synchronize()
    assert ef.fused_edge_mlp.launches == before + 1
    err = (got - ref).abs()
    assert err.max().item() <= K1_TOL and err.mean().item() <= K1_MEAN_TOL
    assert (got[:, 7] == 0).all() and (got[1, -1] == 0).all()


@pytest.mark.parametrize("V", [67, 301, 2048])
@pytest.mark.parametrize("D", [4, 12, 16])
@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_k6_recomputed_forward_is_k1_bit_for_bit(cuda, H, D, V):
    """K6's max routing compares its recomputed per-edge outputs with the
    forward's by exact equality, so its recomputed per-vertex max must be
    K1's output bit for bit: on ragged V (the last step and the last
    64-vertex unit partial), a duplicated neighbour column (exact ties),
    vertices with no valid edge and a run of them that kills whole steps.
    At D=4 a 64-row step holds 16 vertices, at D=12 five (rows of odd and
    even vertices mix in one product row pair)."""
    args, dout = _bwd_args(cuda, H, D=D, V=V, seed=H + D + V)
    args[3][0, V // 3:V // 3 + 40] = False
    before = (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_bwd.launches)
    k1 = ef.fused_edge_mlp(*args)
    grads, fwd = ef.fused_edge_mlp_bwd(*args, dout, return_forward=True)
    torch.cuda.synchronize()
    assert (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(fwd, k1)
    assert (fwd[:, 7] == 0).all() and (fwd[0, V // 3:V // 3 + 40] == 0).all()
    assert all(torch.isfinite(x).all() for x in grads)


def _table_args(dev, H, V, seed, D=12, misaligned=False):
    """Random full-table neighbours for B meshes of V vertices, B chosen so
    that the output holds at least 640 rows (a rare one-ulp LN1 rounding
    difference must not move the mean error past K1_MEAN_TOL), with the
    last mesh's mask all false; `misaligned`: a and b are views 2 bytes past
    a 16-byte boundary."""
    B = max(2, -(-640 // V))
    g = torch.Generator(device=dev).manual_seed(seed)

    def table():
        flat = torch.randn(B * V * H + 1, device=dev, generator=g).to(torch.bfloat16)
        return flat[1:].view(B, V, H) if misaligned else flat[:-1].view(B, V, H)

    a, b = table(), table()
    nbr = torch.randint(0, V, (B, V, D), device=dev, generator=g)
    mask = torch.rand(B, V, D, device=dev, generator=g) < 0.7
    mask[-1] = False
    w2 = torch.randn(H, H, device=dev, generator=g) / math.sqrt(H)
    vecs = [0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g),
            torch.rand(H, device=dev, generator=g) + 0.5,
            0.1 * torch.randn(H, device=dev, generator=g)]
    return a, b, nbr, mask, w2, *vecs


@pytest.mark.parametrize("case", ["V1", "V64", "V65", "V1536", "last_row", "misaligned"])
@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_edge_mlp_kernel_table_cases(cuda, H, case):
    """K1 against its plain version where the last 64-vertex unit of a mesh
    holds 1 (V=1, 65) or 64 (V=64, 1536) vertices, where every neighbour is
    the last row (V=301), and on a and b views that are not 16-byte aligned
    (V=301); each with a mesh whose mask is all false (all zeros)."""
    V = {"V1": 1, "V64": 64, "V65": 65, "V1536": 1536}.get(case, 301)
    args = _table_args(cuda, H, V, seed=H + V, misaligned=case == "misaligned")
    if case == "last_row":
        args[2].fill_(V - 1)
    if case == "misaligned":
        assert args[0].data_ptr() % 16 == 2 and args[1].data_ptr() % 16 == 2
    before = (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_bwd.launches)
    got = ef.fused_edge_mlp(*args)
    ref = ef.edge_mlp_plain(*args)
    torch.cuda.synchronize()
    assert (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_bwd.launches) == (
        before[0] + 1, before[1])
    err = (got - ref).abs()
    assert err.max().item() <= K1_TOL and err.mean().item() <= K1_MEAN_TOL
    assert (got[-1] == 0).all() and torch.isfinite(got).all()


def test_serving_and_training_count_apart(cuda):
    """Serving's fused_edge_mlp counts K1 only; the trainable tail's forward
    is K1 too and counts there, its backward counts K6 only."""
    args = _edge_args(cuda, 32)
    counts = lambda: (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_bwd.launches)
    k1, k6 = counts()
    ef.fused_edge_mlp(*args)
    assert counts() == (k1 + 1, k6)
    a, b = (t.float().requires_grad_() for t in args[:2])
    out = ef.fused_edge_mlp_trainable(a, b, *args[2:])
    assert counts() == (k1 + 2, k6)
    out.sum().backward()
    torch.cuda.synchronize()
    assert counts() == (k1 + 2, k6 + 1)


def _bwd_args(dev, H, D=12, V=301, seed=0):
    """_edge_args with neighbour column 1 a copy of column 0 (exact ties in
    the max) and a seeded dout."""
    a, b, nbr, mask, *rest = _edge_args(dev, H, V=V, D=D, seed=seed)
    nbr[:, :, 1] = nbr[:, :, 0]
    mask[:, :, 1] = mask[:, :, 0]
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    dout = torch.randn(a.shape[0], V, H, device=dev, generator=g)
    return (a, b, nbr, mask, *rest), dout


def assert_k6_close(got, ref):
    for name, x, y in zip(K6_NAMES, got, ref):
        assert x.shape == y.shape and x.dtype == torch.float32, name
        assert torch.isfinite(x).all(), name
        rel = ((x - y).norm() / y.norm().clamp(min=1e-30)).item()
        assert rel <= K6_L2_TOL, (name, rel)
        if name in ("da", "db_table"):
            err = (x - y).abs()
            frac = (err > K6_ELEM_TOL * max(y.abs().max().item(), 1.0)).float().mean().item()
            assert frac <= K6_FRAC_TOL, (name, frac, err.max().item())


@pytest.mark.parametrize("D", [4, 12, 16])
@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_edge_mlp_bwd_kernel_matches_plain(cuda, H, D):
    """At D=4 a 64-row step holds 16 vertices, two per warp."""
    args, dout = _bwd_args(cuda, H, D=D, seed=H + D)
    before = ef.fused_edge_mlp_bwd.launches
    got = ef.fused_edge_mlp_bwd(*args, dout)
    ref = ef.edge_mlp_bwd_plain(*args, dout)
    torch.cuda.synchronize()
    assert ef.fused_edge_mlp_bwd.launches == before + 1
    assert_k6_close(got, ref)
    assert (got[0][:, 7] == 0).all() and (got[0][1, -1] == 0).all()   # no valid edge


# K6 through the trainable on the card against the same Function on the CPU
# where the routing cannot differ.  Both sides round LN1's output h to bf16
# from fp32 values summed in another order, and a rare h lands one bf16 ulp
# apart, which moves its row's s = h W2 + b2 by up to that ulp times |W2|;
# every other difference is fp32 summation order.  Where such a difference
# moves an s across 0 (the second ReLU) or reorders a near-tie of the max,
# that row's gradient takes another route on the card, which at B=2, V=301
# moves more than K6_FRAC_TOL of db_table's entries at once.  `k6_near_ties`
# finds, from the forward in float64, the (vertex, channel) entries of dout
# whose route could differ: the h entries within K6_H_REL (relative, at
# least 1) of a bf16 rounding boundary, each row's resulting bound on s's
# change (plus K6_DELTA for the summation order) and the bound it gives on
# LN2's output; then a channel of a vertex whose maximal edge is not alone
# within those bounds (exact ties of duplicated neighbours compute alike),
# or whose possibly maximal edge has an s within its bound of 0.  Those
# entries' dout is 0 on both sides, at most K6_NEAR_FRAC of the valid
# vertices' entries.
K6_DELTA, K6_H_REL, K6_NEAR_FRAC = 1e-5, 1e-5, 0.1


def k6_near_ties(args):
    """(B, V, H) bool, on the CPU: the entries of dout whose gradient route
    K6 and its plain version could take apart (the rule above)."""
    a, b, nbr, mask, w2, b2, g1, be1, g2, be2 = (t.detach().cpu() for t in args)
    a, b, w2 = (t.to(torch.bfloat16).double() for t in (a, b, w2))
    b2, g1, be1, g2, be2 = (t.double() for t in (b2, g1, be1, g2, be2))

    def ln(x):
        d = x - x.mean(-1, keepdim=True)
        inv = torch.rsqrt((d * d).mean(-1, keepdim=True) + ef.LN_EPS)
        return d * inv, inv

    bsel = torch.arange(a.shape[0])[:, None, None]
    h = ln((a[:, :, None, :] + b[bsel, nbr]).clamp_min(0))[0] * g1 + be1
    t = K6_H_REL * h.abs().clamp_min(1.0)
    step = (h + t).to(torch.bfloat16).double() - (h - t).to(torch.bfloat16).double()
    s = h.to(torch.bfloat16).double() @ w2 + b2
    ds = step @ w2.abs() + K6_DELTA * (1 + s.abs())
    xn2, inv2 = ln(s.clamp_min(0))
    y = xn2 * g2 + be2
    dmax = ds.amax(-1, keepdim=True)
    dy = g2.abs() * inv2 * (ds + dmax + xn2.abs() * inv2 * dmax) + K6_DELTA * (1 + y.abs())
    valid = mask[..., None]
    yv = torch.where(valid, y, torch.tensor(float("-inf"), dtype=y.dtype))
    top = yv.amax(2, keepdim=True)
    dtop = torch.where(yv == top, dy, torch.zeros_like(dy)).amax(2, keepdim=True)
    cand = valid & (yv >= top - dy - dtop)
    relu_near = (s.abs() <= ds).any(-1, keepdim=True)
    near = (cand & (yv != top)).any(2) | (cand & relu_near).any(2)
    return near & mask.any(-1)[..., None]


def _trainable_card_and_cpu(cuda, args, dout):
    """The gradients of a, b, W2 and the vectors through
    fused_edge_mlp_trainable, on the card and on the CPU."""
    a, b, nbr, mask, *params = args
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().float().to(dev).requires_grad_() for t in (a, b, *params)]
        out = ef.fused_edge_mlp_trainable(leaves[0], leaves[1], nbr.to(dev), mask.to(dev),
                                          *leaves[2:])
        (out * dout.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    torch.cuda.synchronize()
    return grads


def test_trainable_tail_on_card_matches_cpu_plain(cuda):
    """Gradients through fused_edge_mlp_trainable (K1 forward, K6 backward)
    on the card against the same Function on the CPU (plain versions), at
    B=2, V=301 (no multiple of the tile: padded rows), where the routing
    cannot differ: the dout entries `k6_near_ties` finds are 0 on both
    sides (at most K6_NEAR_FRAC), then the K6 tolerances.  Without that a
    single near-tie route flip moves more than K6_FRAC_TOL of db_table's
    entries here (5 of 64 seeds at 128, tools/torch_k6_flip_probe.py)."""
    args, dout = _bwd_args(cuda, 128, seed=5)
    near = k6_near_ties(args)
    valid = int(args[3].any(-1).sum()) * near.shape[-1]
    print(f"K6 trainable B=2 V=301: {int(near.sum())} of {valid} dout entries near a tie")
    assert int(near.sum()) <= K6_NEAR_FRAC * valid
    grads = _trainable_card_and_cpu(cuda, args, dout * (~near).to(cuda))
    assert_k6_close(grads[0], grads[1])


def test_trainable_tail_on_card_matches_cpu_plain_on_training_tables(cuda):
    """The same on the training tables (B=4, V=2048 with 1298 valid rows,
    D=12, neighbour column 1 a copy of column 0) with the whole dout: there
    K6_FRAC_TOL admits the entries one near-tie route flip moves (K6's rule,
    chip_smoke.py `k6_agree`)."""
    args, dout = _training_tables(cuda, 128, 12, seed=5)
    nbr, mask = args[2], args[3]
    nbr[:, :, 1], mask[:, :, 1] = nbr[:, :, 0], mask[:, :, 0]
    grads = _trainable_card_and_cpu(cuda, args, dout)
    assert_k6_close(grads[0], grads[1])


WIDTHS = [16, 32, 64, 128, 256]


@pytest.mark.parametrize("H", WIDTHS)
def test_edge_mlp_bwd_skips_dead_steps(cuda, H):
    """Whole dead 64-row steps: 80 consecutive vertices of batch row 0 with
    no valid edge (960 masked rows at D=12) and batch row 1 all padding.
    K6 against its plain version; the dead vertices' da rows and batch row
    1's db_table rows are exactly 0."""
    args, dout = _bwd_args(cuda, H, seed=H + 40)
    args[3][0, 100:180] = False
    args[3][1] = False
    got = ef.fused_edge_mlp_bwd(*args, dout)
    ref = ef.edge_mlp_bwd_plain(*args, dout)
    torch.cuda.synchronize()
    assert_k6_close(got, ref)
    assert (got[0][0, 100:180] == 0).all() and (got[0][1] == 0).all() and (got[1][1] == 0).all()


@pytest.mark.parametrize("H", WIDTHS)
def test_edge_mlp_bwd_all_masked_is_zero(cuda, H):
    """A batch with no valid edge: no step is live, no dW2 tile exists, and
    every gradient is exactly 0."""
    args, dout = _bwd_args(cuda, H, seed=H + 50)
    args[3].fill_(False)
    got = ef.fused_edge_mlp_bwd(*args, dout)
    torch.cuda.synchronize()
    for name, x in zip(K6_NAMES, got):
        assert (x == 0).all(), name


@pytest.mark.parametrize("V,D", [(302, 12), (67, 16), (33, 4), (13, 12)])
@pytest.mark.parametrize("H", [32, 256])
def test_edge_mlp_bwd_ragged_last_step(cuda, H, V, D):
    """V not a multiple of a step's 64 // D vertices: the last step of each
    batch row holds 2 of 5 (V=302, D=12), 3 of 4 (V=67, D=16), 1 of 16 (V=33,
    D=4) or 3 of 5 (V=13) vertices.  Against the same inputs with the last
    step filled by vertices with no valid edge (the same steps, tiles, grid
    and recomputed bits, so the same routes): da, dW2 and the vector
    gradients bit for bit, db_table to its atomics' order, the filler's da
    rows 0.  The plain version is held in test_edge_mlp_bwd_kernel_matches_plain
    (V=301 is ragged too): here a near-tie of the max that the kernel's and
    the plain version's bf16 roundings route apart would move a whole
    vertex's rows, more than K6_FRAC_TOL at V=67, so a plain comparison
    would hold only for chosen seeds."""
    args, dout = _bwd_args(cuda, H, D=D, V=V, seed=H + V)
    got = ef.fused_edge_mlp_bwd(*args, dout)
    vpt = 64 // D
    pad = -V % vpt
    a, b, nbr, mask, *rest = args
    full = [torch.cat([t, torch.zeros_like(t[:, :pad])], 1) for t in (a, b, nbr, mask)]
    fill = ef.fused_edge_mlp_bwd(*full, *rest, torch.cat([dout, dout[:, :pad]], 1))
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in got)
    assert (fill[0][:, V:] == 0).all()
    for name, x, y in zip(K6_NAMES, got, fill):
        y = y[:, :V] if name in ("da", "db_table") else y
        if name == "db_table":
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("H", [64, 128, 256])
def test_edge_mlp_bwd_misaligned_views(cuda, H):
    """a and b views 2 bytes past a 16-byte boundary (the LN1 backward reads
    their rows in 4-16-byte pieces, so the wrapper copies them)."""
    args, dout = _bwd_args(cuda, H, seed=H + 60)
    a, b = (torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape) for t in args[:2])
    assert a.data_ptr() % 16 == 2 and b.data_ptr() % 16 == 2
    got = ef.fused_edge_mlp_bwd(a, b, *args[2:], dout)
    ref = ef.edge_mlp_bwd_plain(*args, dout)
    torch.cuda.synchronize()
    assert_k6_close(got, ref)


@pytest.mark.parametrize("which", ["1", "2", "grid-1", "grid", "grid+1"])
@pytest.mark.parametrize("H", WIDTHS)
def test_edge_mlp_dw2_kernel_matches_plain(cuda, H, which):
    """K6's dW2 kernel alone over packed scratch tiles with 1, 2, and its
    grid's split count - 1, + 0, + 1 live tiles among dead ones (whose tiles
    hold NaN: they must not be read), against its plain version (fp32 sums
    of the same bf16 products in another order); twice, bit for bit."""
    from morig_tpu_torch.kernels import build as kb

    splits = ef._dw2_splits(kb.library(), H)
    n_live = max(1, {"1": 1, "2": 2, "grid-1": splits - 1, "grid": splits,
                     "grid+1": splits + 1}[which])
    g = torch.Generator(device=cuda).manual_seed(H + n_live)
    n = 2 * n_live + 3
    live = torch.zeros(n, dtype=torch.bool, device=cuda)
    live[torch.randperm(n, device=cuda, generator=g)[:n_live]] = True
    h = torch.randn(n, 64, H, device=cuda, generator=g)
    ds = torch.randn(n, 64, H, device=cuda, generator=g)
    scratch = ef.pack_dw2_scratch(h, ds)
    scratch[~live] = float("nan")
    before = ef.fused_edge_mlp_dw2.launches
    got = ef.fused_edge_mlp_dw2(scratch, live)
    again = ef.fused_edge_mlp_dw2(scratch, live)
    ref = ef.edge_mlp_dw2_plain(scratch, live)
    torch.cuda.synchronize()
    assert ef.fused_edge_mlp_dw2.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())


# One parameter's gradient after a CorrNet training step, and the whole
# gradient vector: tests/torch_port_fixtures.py GRAD and GRAD_TOTAL (bf16
# backward noise amplified through 8 edge layers and a max over vertices),
# the step's sanity check; each GCU's backward is held by relative L2 at
# K6_L2_TOL.
GRAD, GRAD_TOTAL = (0.3, 0.6), 8e-2


def _pose_dataset():
    from morig_tpu_torch.data.pose import PoseDataset, capsule_pose_dataset

    ds = capsule_pose_dataset(num_models=2, num_frames=4, num_points=128, n_lat=7, n_lon=6)
    return PoseDataset(ds.models, tpl_max_degree=12, geo_max_degree=12, buckets=(128,))


@pytest.mark.parametrize("fin,out", [(3, 32), (32, 64), (64, 256), (256, 512)])
def test_gcu_train_backward_on_card_matches_cpu(cuda, fin, out):
    """Each of CorrNet's GCUs in training (two edge layers through K1 + K6 on
    the card, their plain versions on the CPU; the fuse MLP in fp32) from the
    same weights, input and dout on the valid vertices: the output, the
    input's gradient and every parameter's gradient by relative L2 at
    K6_L2_TOL.  K1 on the card and its plain version land a rare element
    one bf16 ulp apart, which can flip a near-tie route of the max and move
    a whole vertex's rows (K6's rule above), so no entry-wise bound."""
    import copy

    from morig_tpu_torch.nn.gcu import GCU
    from morig_tpu_torch.nn.mlp import init_parameters

    ds = _pose_dataset()
    net = GCU(fin, out)
    init_parameters(net, torch.Generator().manual_seed(out))
    g = torch.Generator().manual_seed(fin)
    x = torch.randn(2, 128, fin, generator=g)
    dout = torch.randn(2, 128, out, generator=g)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        mesh = ds.batch([0, 1], 0, 2, device=dev).mesh
        m = copy.deepcopy(net).to(dev)
        xd = x.to(dev).requires_grad_()
        y = m(xd, mesh, train=True)
        y.backward(dout.to(dev) * mesh.vert_mask[..., None])
        vm = mesh.vert_mask.cpu()
        runs.append([("out", y.detach().cpu()[vm]), ("dx", xd.grad.cpu()[vm])]
                    + [(n, p.grad.cpu()) for n, p in m.named_parameters()])
    for (n, got), (_, ref) in zip(*runs):
        assert torch.isfinite(got).all(), n
        rel = ((got - ref).norm() / ref.norm().clamp(min=1e-30)).item()
        assert rel <= K6_L2_TOL, (n, rel)


def test_corr_pose_step_on_card_matches_cpu(cuda):
    """One CorrPoseStage train step from the same weights on the same batch:
    losses at 2e-2 relative, gradients (after each side's clip, by norms
    that agree to 2e-2) at GRAD, parameters after the step within 2 lr
    (Adam's first step moves each by about lr times the gradient's sign)."""
    from morig_tpu_torch.train.stages import CorrPoseStage

    ds = _pose_dataset()
    stage = CorrPoseStage()
    stage.train_vismask = True
    runs = []
    for dev in (cuda, torch.device("cpu")):
        state = stage.init_state(0, device=dev)
        metrics = stage.train_step(state, ds.batch([0, 1], 0, 2, device=dev))
        runs.append((metrics, {n: (p.grad.cpu(), p.detach().cpu())
                               for n, p in state.model.named_parameters()}))
    (m_card, p_card), (m_cpu, p_cpu) = runs
    for k in ("corr_loss", "vis_loss", "total_loss", "grad_norm"):
        assert abs(m_card[k] - m_cpu[k]) <= 2e-2 * abs(m_cpu[k]), (k, m_card[k], m_cpu[k])
    lr = stage.cfg.train.lr
    for n, (g, w) in p_card.items():
        g_ref, w_ref = p_cpu[n]
        err = (g - g_ref).abs()
        assert err.mean() <= GRAD[0] * g_ref.abs().mean() + 1e-12, n
        assert err.max() <= GRAD[1] * g_ref.abs().max() + 1e-12, n
        assert (w - w_ref).abs().max() <= 2 * lr, n
    flat = torch.cat([g.ravel() for g, _ in p_card.values()])
    flat_ref = torch.cat([g.ravel() for g, _ in p_cpu.values()])
    assert (flat - flat_ref).norm() <= GRAD_TOTAL * flat_ref.norm()


# The CPU parity tests' bounds (tests/torch_port_fixtures.py), mean and max
# |err| relative to mean and max |ref|: LAYER_GRAD for one module's
# gradients behind edge layers, NETWORK for a whole network's outputs.
LAYER_GRAD, NETWORK = (5e-4, 5e-3), (2e-2, 5e-2)


def _rel_close(got, ref, tol, what):
    err = (got - ref).abs()
    assert torch.isfinite(got).all(), what
    assert err.mean() <= tol[0] * ref.abs().mean(), (what, err.mean().item(), ref.abs().mean().item())
    assert err.max() <= tol[1] * ref.abs().max(), (what, err.max().item(), ref.abs().max().item())


def _skel_module_calls(model, stage, batch):
    """One training forward and backward of `model` on `batch`, recording for
    each trained child module (the shape encoder's GCUs and MLP, every
    PointNet++ stage, the MLP heads) its call's inputs and the gradient of
    the loss with respect to its output (a tuple's first element)."""
    calls = {}
    names = [n for n, m in model.named_modules()
             if type(m).__name__ in ("GCU", "MLP", "MLPHead", "Dense", "SAModule",
                                     "GlobalSAModule", "FPModule")]
    names = [n for n in names if not any(n.startswith(o + ".") for o in names)]

    def hook(name):
        def record(module, args, out):
            y = out[0] if isinstance(out, tuple) else out
            entry = calls[name] = [tuple(a.detach() if torch.is_tensor(a) else a for a in args),
                                   None]
            y.register_hook(lambda g: entry.__setitem__(1, g.detach().clone()))
        return record

    handles = [model.get_submodule(n).register_forward_hook(hook(n)) for n in names]
    try:
        stage._losses(stage._forward(model, batch, True, None), batch)[0].backward()
    finally:
        for h in handles:
            h.remove()
    model.zero_grad(set_to_none=True)
    return calls


# Adam's first step, as test_torch_skel_train holds it against JAX's: where
# the reference's effective gradient (clipped, plus the L2 decay) is at
# least 1e-2 of its tensor's largest and at least 1e-4, the step has the
# reference's sign and lies within 1e-2 lr of it, on at least
# UPDATE_AGREE of those entries in all and UPDATE_AGREE_TENSOR in each
# tensor; a zero or sign-flipped update fails.
UPDATE_AGREE, UPDATE_AGREE_TENSOR = 0.99, 0.75


def _adam_first_step_agreement(before, after, ref_after, ref_g, lr, what):
    """(entries held, entries whose step agrees with the reference's)."""
    before, after, ref_after, ref_g = (x.double().flatten() for x in
                                       (before, after, ref_after, ref_g))
    held = ref_g.abs() >= max(1e-2 * ref_g.abs().max().item(), 1e-4)
    if not held.any():
        return 0, 0
    d, d_ref = (after - before)[held], (ref_after - before)[held]
    assert d_ref.abs().min() >= 0.5 * lr, what
    agree = (d.sign() == d_ref.sign()) & ((d - d_ref).abs() <= 1e-2 * lr + 1e-6 * before[held].abs())
    assert agree.double().mean() >= UPDATE_AGREE_TENSOR, (what, int(held.sum()), int(agree.sum()))
    return int(held.sum()), int(agree.sum())


@pytest.mark.parametrize("kind", ["bone", "root"])
def test_skel_step_on_card_matches_cpu(cuda, kind, monkeypatch):
    """A BoneStage or RootStage step from the same filled weights (heads
    included) on the capsule skeleton sample (V=256, degree 16, 8 joint
    slots), BoneNet with dropout 0 and one fixed pair swap on both devices.
    The step: losses and gradient norm at 2e-2 relative, the parameters
    after it within 2 lr, and where the CPU step's gradient is not near
    zero (at least 0.4 of the parameters), moved as the CPU step moved
    them (_adam_first_step_agreement).  Its modules: each trained module of the network
    (the shape encoder's three GCUs, whose edge layers run K1 + K6 on the
    card and their plain versions on the CPU, its MLP, every PointNet++
    stage, the MLP heads) fed the CPU step's inputs and output gradient on
    both devices: every parameter gradient at LAYER_GRAD.  (The whole
    step's gradients are not held entry-wise: a global max over vertices
    routes each channel's gradient to one vertex, which a one-ulp
    difference can change.)  The eval logits at NETWORK, the CPU run at the
    card's inference precision (bf16 MLP products)."""
    import copy

    from morig_tpu_torch.data.skeleton_data import capsule_skel_dataset
    from morig_tpu_torch.nn import bonenet, mlp
    from morig_tpu_torch.train.stages import BoneStage, RootStage
    from morig_tpu_torch.weights import randomize_

    stage = BoneStage() if kind == "bone" else RootStage()
    swap = torch.rand(2, 28, 1, generator=torch.Generator().manual_seed(3)) < 0.5
    monkeypatch.setattr(bonenet, "pair_swap", lambda g, B, P, device: swap.to(device))
    monkeypatch.setattr(mlp, "matmul_dtype",
                        lambda x, train=False: torch.float32 if train else torch.bfloat16)
    runs, batches = [], {}
    for dev in (cuda, torch.device("cpu")):
        batch = batches[dev.type] = capsule_skel_dataset(2, max_joints=8, num_points=64, n_lat=9,
                                                         n_lon=8, device=dev)
        state = stage.init_state(0, device=dev)
        randomize_(state.model, 7)
        state.model.dropout = 0.0
        p0 = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
        logits = stage.infer(state, batch).cpu()
        metrics = stage.train_step(state, batch, torch.Generator(device=dev).manual_seed(0))
        # after the step each .grad holds the clipped gradient the step used
        runs.append((metrics, logits, {n: p.detach().cpu()
                                       for n, p in state.model.named_parameters()},
                     {n: p.grad.cpu() for n, p in state.model.named_parameters()}))
    (m_card, l_card, p_card, _), (m_cpu, l_cpu, p_cpu, g_cpu) = runs
    for k in m_cpu:
        assert abs(m_card[k] - m_cpu[k]) <= 2e-2 * abs(m_cpu[k]) + 1e-12, (k, m_card[k], m_cpu[k])
    held = agree = total = 0
    for n, w in p_card.items():
        assert (w - p_cpu[n]).abs().max() <= 2 * 1e-3, n
        g = g_cpu[n] + stage.cfg.train.weight_decay * p0[n]
        h, a = _adam_first_step_agreement(p0[n], w, p_cpu[n], g, 1e-3, n)
        held, agree, total = held + h, agree + a, total + w.numel()
    print(f"{kind} step: {held} of {total} parameters held, {agree} agree with the CPU step")
    assert held >= 0.4 * total and agree >= UPDATE_AGREE * held, (held, agree, total)
    valid = (batches["cpu"].pair_mask if kind == "bone" else batches["cpu"].joints_mask)
    _rel_close(l_card[valid], l_cpu[valid], NETWORK, "eval logits")

    model = randomize_(stage.init_state(0, device="cpu").model, 7)
    model.dropout = 0.0
    calls = _skel_module_calls(model, stage, batches["cpu"])
    assert len(calls) == (10 if kind == "bone" else 11), sorted(calls)
    for name, (args, dout) in calls.items():
        grads = []
        for dev in (cuda, torch.device("cpu")):
            m = copy.deepcopy(model.get_submodule(name)).to(dev)
            out = m(*(a.to(dev) if hasattr(a, "to") else a for a in args))
            (out[0] if isinstance(out, tuple) else out).backward(dout.to(dev))
            grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
        scale = max(g.abs().max().item() for g in grads[1].values())
        for n, g_ref in grads[1].items():
            g = grads[0][n]
            if g_ref.abs().max() <= 1e-5 * scale:
                # RootNet: the cross-entropy's gradient sums to 0 over the
                # joints, so the biases after the head's last LayerNorm get
                # rounding only
                assert g.abs().max() <= 1e-5 * scale, (name, n)
            else:
                _rel_close(g, g_ref, LAYER_GRAD, f"{name}.{n}")


@pytest.mark.parametrize("pos_feat,out", [(16, 128), (64, 256)])
def test_gcu_motion_training_kernels_match_plain(cuda, pos_feat, out):
    """A GCUMotion in training on creature tables (degree 16, V padded to
    1024), as the motion stages run it: GCNDeform's first unit (feature 64
    wide, positions 16) and SkinNet's (128 and 64).  Its edge layers take
    the JAX package's training split: the 128-wide feature layers K1 + K6,
    each K1 call held to the plain version and each K6 call, with the dout
    the layer's backward really received, to edge_mlp_bwd_plain by relative
    L2 (assert_k6_close); the narrower ones `narrow_edge_trainable` (KN +
    KNB), each
    call's output and gradients (with its dout) held to the same call on the
    CPU (`_narrow_card_against_cpu`)."""
    from morig_tpu_torch.data.creature import creature_rig_dataset
    from morig_tpu_torch.nn import gcu
    from morig_tpu_torch.weights import randomize_

    batch = creature_rig_dataset(num_models=2, seed=0, num_keyframes=1, num_points=64,
                                 target_verts=600).batch([0, 1], device=cuda)
    mesh = batch.mesh
    assert mesh.tpl_nbr.shape[-1] == 16
    net = randomize_(gcu.GCUMotion(3, 4, out, pos_feat), out).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(out)
    x = torch.randn(*mesh.verts.shape[:2], 4, device=cuda, generator=g)
    w = torch.randn(*mesh.verts.shape[:2], out, device=cuda, generator=g)
    calls, narrow_calls = [], []
    original, narrow = gcu.fused_edge_mlp_trainable, gcu.narrow_edge_trainable

    def record(a, b, nbr, mask, *params, **kw):
        y = original(a, b, nbr, mask, *params, **kw)
        entry = [(a.detach().to(torch.bfloat16), b.detach().to(torch.bfloat16), nbr, mask,
                  *(q.detach().clone() for q in params)), None]
        y.register_hook(lambda d, e=entry: e.__setitem__(1, d.detach().float().clone()))
        calls.append(entry)
        return y

    def record_narrow(*args, rev=None):
        y = narrow(*args, rev=rev)
        entry = [tuple(t.detach().clone() for t in args), rev, None]
        y.register_hook(lambda d, e=entry: e.__setitem__(2, d.detach().clone()))
        narrow_calls.append(entry)
        return y

    gcu.fused_edge_mlp_trainable, gcu.narrow_edge_trainable = record, record_narrow
    try:
        ((net(mesh.verts, x, mesh, train=True) * w).sum()).backward()
    finally:
        gcu.fused_edge_mlp_trainable, gcu.narrow_edge_trainable = original, narrow
    kernel = [out // 2] * 2 if out // 2 >= 128 else []
    assert sorted(args[0].shape[-1] for args, _ in calls) == kernel
    assert sorted(e[0][0].shape[-1] for e in narrow_calls) == sorted(
        [pos_feat] * 2 + ([out // 2] * 2 if not kernel else []))
    for args, dout in calls:
        got, ref = ef.fused_edge_mlp(*args), ef.edge_mlp_plain(*args)
        err = (got - ref).abs()
        assert err.max() <= K1_TOL and err.mean() <= K1_MEAN_TOL, args[0].shape
        assert dout is not None and torch.isfinite(dout).all()
        assert_k6_close(ef.fused_edge_mlp_bwd(*args, dout), ef.edge_mlp_bwd_plain(*args, dout))
        torch.cuda.synchronize()
    for args, rev, dout in narrow_calls:
        assert dout is not None and torch.isfinite(dout).all()
        rel, near, valid = _narrow_card_against_cpu(cuda, args, rev, dout)
        print(f"narrow_edge H={args[0].shape[-1]} on creature tables: card against CPU, "
              f"{near} of {valid} vertices near a tie, relative L2 "
              f"{dict(zip(NARROW_NAMES, rel))}")
        assert near <= NARROW_NEAR_FRAC * valid, (near, valid)
        assert all(v <= NARROW_TOL for v in rel), rel


def _windowed_args(dev, H, D, TV, V, seed, B=2, leave=True):
    """_edge_args with tables local to each vertex tile's window, except
    (with `leave`) for a few valid neighbours that leave it."""
    a, b, _, mask, *rest = _edge_args(dev, H, B=B, V=V, D=D, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    v = torch.arange(V, device=dev)
    ws = ((v // TV - 1).clamp(0, V // TV - 3) * TV)[None, :, None]
    nbr = ws + torch.randint(0, 3 * TV, (B, V, D), device=dev, generator=g)
    if leave:
        nbr[0, :TV, 1] = V - 1                  # outside tile 0's window
        mask[0, 8:TV, 1] = True                 # (row 7 keeps no valid edge)
    return a, b, nbr, mask, *rest


@pytest.mark.parametrize("B", [4, 20])
@pytest.mark.parametrize("D", [12, 16])
@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_edge_mlp_windowed_kernel_matches_plain(cuda, H, D, B):
    """K5 at the paths' tile and size (TV=128, V=1536, B=4 and B*T=20), with
    neighbours that leave their window (batch row 0), vertices with no valid
    edge, a last tile of padding (as the capsule's 238 padded rows) and a
    64-vertex unit whose slots from d=3 on are all masked: against its plain
    version, and against K1 where every neighbour is in its window."""
    TV, V = 128, 1536
    args = _windowed_args(cuda, H, D, TV, V, seed=H + D + B, B=B)
    mask = args[3]
    mask[:, -TV:] = False                       # a tile of padding
    mask[:, 3 * TV:3 * TV + 64, 3:] = False     # a unit with dead upper slabs
    before = (ef.fused_edge_mlp_windowed.launches, ef.fused_edge_mlp.launches)
    got = ef.fused_edge_mlp_windowed(*args, tile_v=TV)
    ref = ef.edge_mlp_windowed_plain(*args, tile_v=TV)
    torch.cuda.synchronize()
    assert (ef.fused_edge_mlp_windowed.launches, ef.fused_edge_mlp.launches) == (
        before[0] + 1, before[1])
    err = (got - ref).abs()
    assert err.max().item() <= K1_TOL and err.mean().item() <= K1_MEAN_TOL
    assert (got[:, 7] == 0).all() and (got[1, -1] == 0).all() and (got[:, -TV:] == 0).all()
    # where every neighbour is in its window K5 computes K1's function
    k1 = ef.fused_edge_mlp(*args)
    full = ef.edge_mlp_plain(*args)
    e1 = (got - k1).abs()[1:]
    assert e1.max().item() <= K1_TOL and e1.mean().item() <= K1_MEAN_TOL
    assert ((got - full).abs()[1:].max().item() <= K1_TOL
            and not torch.allclose(got[0, :TV], full[0, :TV]))


@pytest.mark.parametrize("B", [4, 20])
@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_edge_mlp_kernel_matches_windowed_on_local_tables(cuda, H, B):
    """K1 against K5 at the paths' size (V=1536, D=12, TV=128, B=4 and
    B*T=20) on tables local to every window, where both compute the same
    function; a tile of padding."""
    TV, V = 128, 1536
    args = _windowed_args(cuda, H, 12, TV, V, seed=H + B, B=B, leave=False)
    args[3][:, -TV:] = False
    got = ef.fused_edge_mlp(*args)
    k5 = ef.fused_edge_mlp_windowed(*args, tile_v=TV)
    torch.cuda.synchronize()
    err = (got - k5).abs()
    assert err.max().item() <= K1_TOL and err.mean().item() <= K1_MEAN_TOL
    assert (got[:, -TV:] == 0).all()


def _knn_args(dev, C, seed, N=200, P=300):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(3, N, C, device=dev, generator=g), dim=-1)
    c = torch.nn.functional.normalize(torch.randn(3, P, C, device=dev, generator=g), dim=-1)
    c[0, 150] = c[0, 20]                        # duplicate candidates: 20 wins
    q[0, 5] = c[0, 20]
    mask = torch.rand(3, P, device=dev, generator=g) < 0.8
    mask[0, 20] = mask[0, 150] = True
    mask[1] = False                             # an all-masked batch row
    mask[2] = False
    mask[2, [11, 260]] = True                   # fewer valid candidates than k
    values = torch.randn(3, P, 5, device=dev, generator=g)
    return q, c, mask, values


@pytest.mark.parametrize("C", [64])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_kernel_matches_plain(cuda, k, C):
    q, c, mask, values = _knn_args(cuda, C, seed=k * C)
    before = kf.knn_batched.launches
    idx, score, gathered = kf.knn_batched(q, c, k, mask, gather_values=values)
    ref_idx, ref_score, _ = kf.knn_plain(q, c, k + 1, mask, values)
    torch.cuda.synchronize()
    assert kf.knn_batched.launches == before + 1
    assert (score - ref_score[..., :k]).abs().max().item() <= K2_TOL
    # indices agree wherever the k+1 best scores are separated by more
    # than the tolerance (elsewhere the order is a tie)
    hi, lo = ref_score[..., :-1], ref_score[..., 1:]
    gaps = torch.where((hi < kf.NEG / 2) & (lo < kf.NEG / 2),
                       torch.full_like(hi, float("inf")), (hi - lo).abs())
    decided = gaps.min(-1).values > K2_TOL
    assert not ((idx != ref_idx[..., :k]).any(-1) & decided).any()
    bsel = torch.arange(3, device=cuda)[:, None, None]
    assert torch.equal(gathered, values[bsel, idx])
    assert idx[0, 5, 0].item() == 20
    assert (idx[1] == 0).all() and (score[1] < -1e29).all()
    if k > 2:
        assert (idx[2, :, 2:] == 0).all() and (score[2, :, 2:] < -1e29).all()


@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_without_values_kernel_matches_plain(cuda, k):
    """K4: K2's scan with the gather compiled out."""
    q, c, mask, _ = _knn_args(cuda, 64, seed=100 + k)
    before = (kf.knn_topk.launches, kf.knn_batched.launches)
    idx, score = kf.knn_batched(q, c, k, mask)
    ref_idx, ref_score = kf.knn_plain(q, c, k + 1, mask)
    torch.cuda.synchronize()
    assert (kf.knn_topk.launches, kf.knn_batched.launches) == (before[0] + 1, before[1])
    assert (score - ref_score[..., :k]).abs().max().item() <= K2_TOL
    hi, lo = ref_score[..., :-1], ref_score[..., 1:]
    gaps = torch.where((hi < kf.NEG / 2) & (lo < kf.NEG / 2),
                       torch.full_like(hi, float("inf")), (hi - lo).abs())
    decided = gaps.min(-1).values > K2_TOL
    assert not ((idx != ref_idx[..., :k]).any(-1) & decided).any()
    assert idx[0, 5, 0].item() == 20
    assert (idx[1] == 0).all() and (score[1] < -1e29).all()


def _assert_knn_matches_plain(q, c, k, mask, values=None):
    """K2 (values given) or K4 against knn_plain: scores within K2_TOL,
    indices equal wherever the order is decided, empty slots (index 0,
    score -1e30) where the plain version's are, the gather exact.  Returns
    the kernel's (idx, score)."""
    counter = kf.knn_topk if values is None else kf.knn_batched
    before = counter.launches
    out = kf.knn_batched(q, c, k, mask, gather_values=values)
    idx, score = out[:2]
    ref_idx, ref_score = kf.knn_plain(q, c, k + 1, mask)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert idx.shape == score.shape == (*q.shape[:2], k)
    assert (score - ref_score[..., :k]).abs().max().item() <= K2_TOL
    hi, lo = ref_score[..., :-1], ref_score[..., 1:]
    gaps = torch.where((hi < kf.NEG / 2) & (lo < kf.NEG / 2),
                       torch.full_like(hi, float("inf")), (hi - lo).abs())
    decided = gaps.min(-1).values > K2_TOL
    assert not ((idx != ref_idx[..., :k]).any(-1) & decided).any()
    empty = ref_score[..., :k] < kf.NEG / 2
    assert (idx[empty] == 0).all() and (score[empty] == kf.NEG).all()
    if values is not None:
        bsel = torch.arange(q.shape[0], device=q.device)[:, None, None]
        assert torch.equal(out[2], values[bsel, idx])
    return idx, score


@pytest.mark.parametrize("k", [1, 2, 5, 8])
@pytest.mark.parametrize("P", [1, 7, 64, 65, 129, 300])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 200])
def test_knn_kernel_ragged_shapes(cuda, N, P, k):
    """No multiple of a slab (64 queries) or a tile assumed: partial slabs
    and tiles, fewer candidates than k, with the gather at Cv = 3 and 64
    and without it."""
    g = torch.Generator(device=cuda).manual_seed(N * 1000 + P * 10 + k)
    q = torch.nn.functional.normalize(torch.randn(3, N, 64, device=cuda, generator=g), dim=-1)
    c = torch.nn.functional.normalize(torch.randn(3, P, 64, device=cuda, generator=g), dim=-1)
    mask = torch.rand(3, P, device=cuda, generator=g) < 0.8
    mask[1] = False                             # an all-masked batch row
    for Cv in (3, 64, None):
        values = None if Cv is None else torch.randn(3, P, Cv, device=cuda, generator=g)
        idx, score = _assert_knn_matches_plain(q, c, k, mask, values)
        assert (idx[1] == 0).all() and (score[1] == kf.NEG).all()


# 12 copies of one candidate: a pair one thread holds (2, 3), columns other
# lanes of the same quad hold (4, 9), and columns of later tiles
TIE_COLUMNS = [2, 3, 4, 9, 70, 130, 131, 200, 201, 255, 256, 299]


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("k", [5, 8])
def test_knn_kernel_exact_ties(cuda, k, gather):
    """A query equal to a candidate that sits at 12 columns: the k smallest
    of those columns, in order, with bit-equal scores; in every slab."""
    g = torch.Generator(device=cuda).manual_seed(11)
    N, P = 130, 300
    q = torch.nn.functional.normalize(torch.randn(2, N, 64, device=cuda, generator=g), dim=-1)
    c = torch.nn.functional.normalize(torch.randn(2, P, 64, device=cuda, generator=g), dim=-1)
    c[0, TIE_COLUMNS] = c[0, 2].clone()
    rows = [0, 13, 64, 100, 129]                # queries in all three slabs
    q[0, rows] = c[0, 2]
    mask = torch.ones(2, P, dtype=torch.bool, device=cuda)
    values = torch.randn(2, P, 3, device=cuda, generator=g) if gather else None
    idx, score = _assert_knn_matches_plain(q, c, k, mask, values)
    want = torch.tensor(TIE_COLUMNS[:k], device=cuda)
    for n in rows:
        assert torch.equal(idx[0, n], want), (n, idx[0, n].tolist())
        assert (score[0, n] == score[0, n, 0]).all()
    # each copy alone scores the same bits, whichever column holds it
    for col in TIE_COLUMNS:
        only = torch.zeros(1, P, dtype=torch.bool, device=cuda)
        only[0, col] = True
        alone_idx, alone = kf.knn_batched(q[:1, rows], c[:1], 1, only)
        assert (alone_idx == col).all() and torch.equal(alone[0, :, 0], score[0, rows, 0])


def test_knn_kernel_misaligned_views(cuda):
    """q and c views whose base is 2 bytes past a 16-byte boundary are
    copied to an aligned base by the wrapper."""
    g = torch.Generator(device=cuda).manual_seed(12)
    N, P = 97, 150
    fq = torch.randn(2 * N * 64 + 1, device=cuda, generator=g).to(torch.bfloat16)
    fc = torch.randn(2 * P * 64 + 1, device=cuda, generator=g).to(torch.bfloat16)
    q, c = fq[1:].view(2, N, 64), fc[1:].view(2, P, 64)
    assert q.data_ptr() % 16 == 2 and c.data_ptr() % 16 == 2
    mask = torch.rand(2, P, device=cuda, generator=g) < 0.7
    values = torch.randn(2, P, 64, device=cuda, generator=g)
    for k in (1, 5):
        _assert_knn_matches_plain(q, c, k, mask, values)
        _assert_knn_matches_plain(q, c, k, mask)


def _path_knn_inputs(dev):
    """chip_smoke.py's kNN inputs: the serving path's B*T=20, V=1536,
    P=1024 embeddings, points, flow and visibility."""
    g = torch.Generator(device=dev).manual_seed(2)
    Bt, V, P = 20, 1536, 1024
    vtx_f = torch.nn.functional.normalize(torch.randn(Bt, V, 64, device=dev, generator=g), dim=-1)
    pts_f = torch.nn.functional.normalize(torch.randn(Bt, P, 64, device=dev, generator=g), dim=-1)
    pts = torch.randn(Bt, P, 3, device=dev, generator=g)
    flow = torch.randn(Bt, V, 3, device=dev, generator=g)
    all_pts = torch.ones(Bt, P, dtype=torch.bool, device=dev)
    visible = torch.rand(Bt, V, device=dev, generator=g) < 0.4
    visible[0] = False
    visible[1, 3:] = False
    return vtx_f, pts_f, pts, flow, all_pts, visible


@pytest.mark.parametrize("case", ["vismask", "voting", "completion", "voting_k4",
                                  "train_vismask"])
def test_knn_kernel_at_path_shapes(cuda, case):
    """The serving path's three K2 cases (and voting without the gather, K4)
    at B*T=20, V=1536, P=1024; the training step's vismask at B=4, N=2048,
    P=1024, k=1, Cv=64."""
    if case == "train_vismask":
        g = torch.Generator(device=cuda).manual_seed(4)
        vtx = torch.nn.functional.normalize(torch.randn(4, 2048, 64, device=cuda, generator=g),
                                            dim=-1)
        pts_f = torch.nn.functional.normalize(torch.randn(4, 1024, 64, device=cuda, generator=g),
                                              dim=-1)
        _assert_knn_matches_plain(vtx, pts_f, 1, torch.ones(4, 1024, dtype=torch.bool,
                                                            device=cuda), pts_f)
        return
    vtx_f, pts_f, pts, flow, all_pts, visible = _path_knn_inputs(cuda)
    args = {"vismask": (vtx_f, pts_f, 1, all_pts, pts_f),
            "voting": (vtx_f, pts_f, 5, all_pts, pts),
            "completion": (vtx_f, vtx_f, 5, visible, flow),
            "voting_k4": (vtx_f, pts_f, 5, all_pts, None)}[case]
    _assert_knn_matches_plain(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("C", [1, 3, 4, 64, 67, 128, 131, 256])
def test_gather_kernel_is_exact(cuda, C, dtype):
    """Each row class: one thread per row (1, 3), 16-byte vectors (4, 64,
    128, 256), a warp per row of 4-byte elements (67, 131)."""
    g = torch.Generator(device=cuda).manual_seed(C)
    values = (torch.randn(3, 97, C, device=cuda, generator=g) * 1e3).to(dtype)
    idx = torch.randint(0, 97, (3, 41, 7), device=cuda, generator=g)
    before = gf.gather_rows.launches
    got = gf.gather_rows(values, idx)
    assert gf.gather_rows.launches == before + 1
    assert torch.equal(got, gf.gather_plain(values, idx))


# chip_smoke.py check_k3's (B, N, C, M): the main path's K3 shapes
K3_PATH_SHAPES = [(20, 1024, 3, 512 * 64), (20, 512, 67, 128 * 64), (20, 128, 131, 32 * 64),
                  (20, 32, 256, 128 * 3), (20, 128, 128, 512 * 3), (20, 512, 64, 1024 * 3),
                  (4, 48, 4, 48 * 48), (4, 48, 131, 16 * 48), (4, 16, 256, 48 * 3),
                  (4, 48, 128, 48 * 3), (4, 48, 3, 48 * 48)]


@pytest.mark.parametrize("shape", K3_PATH_SHAPES)
def test_gather_kernel_is_exact_at_path_shapes(cuda, shape):
    Bn, N, C, M = shape
    g = torch.Generator(device=cuda).manual_seed(M)
    values = torch.randn(Bn, N, C, device=cuda, generator=g)
    idx = torch.randint(0, N, (Bn, M), device=cuda, generator=g)
    assert torch.equal(gf.gather_rows(values, idx), gf.gather_plain(values, idx))


def test_gather_kernel_scalar_route_and_empty(cuda):
    """A values view 4 bytes past a 16-byte boundary takes the 4-byte route
    even at a width of 64; an empty idx launches nothing."""
    g = torch.Generator(device=cuda).manual_seed(9)
    flat = torch.randn(3 * 97 * 64 + 1, device=cuda, generator=g)
    values = flat[1:].view(3, 97, 64)
    assert values.data_ptr() % 16 == 4
    idx = torch.randint(0, 97, (3, 50), device=cuda, generator=g)
    assert torch.equal(gf.gather_rows(values, idx), gf.gather_plain(values, idx))
    before = gf.gather_rows.launches
    empty = torch.zeros(3, 0, dtype=torch.int64, device=cuda)
    got = gf.gather_rows(values, empty)
    assert got.shape == (3, 0, 64) and gf.gather_rows.launches == before


def test_kernels_refuse_what_they_do_not_take(cuda):
    """On a CUDA tensor an unsupported shape or type raises; nothing runs the
    plain version in the kernel's place."""
    counts = (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_windowed.launches,
              kf.knn_batched.launches, kf.knn_topk.launches, gf.gather_rows.launches)
    k6 = ef.fused_edge_mlp_bwd.launches
    with pytest.raises(ValueError, match="widths"):
        ef.fused_edge_mlp(*_edge_args(cuda, 48))
    with pytest.raises(ValueError, match="degree"):
        ef.fused_edge_mlp(*_edge_args(cuda, 32, D=17))
    a, b, nbr, mask, *rest = _edge_args(cuda, 32)
    with pytest.raises(TypeError, match="bf16"):
        ef.fused_edge_mlp(a.float(), b, nbr, mask, *rest)
    q, c, kmask, values = _knn_args(cuda, 64, seed=0)
    with pytest.raises(ValueError, match="k <= 8"):
        kf.knn_batched(q, c, 9, kmask, gather_values=values)
    with pytest.raises(ValueError, match="feature widths"):
        kf.knn_batched(q[..., :48], c[..., :48], 3, kmask, gather_values=values)
    with pytest.raises(TypeError):
        gf.gather_rows(values.double(), torch.zeros(3, 4, dtype=torch.int64, device=cuda))
    # K3's offsets are 32-bit: 2^31 elements of values or of the result
    one = torch.zeros(1, 1, 1, device=cuda)
    with pytest.raises(ValueError, match="2\\^31"):
        gf.gather_rows(one.expand(1, 2 ** 16, 2 ** 15), torch.zeros(1, 4, dtype=torch.int64,
                                                                     device=cuda))
    with pytest.raises(ValueError, match="2\\^31"):
        gf.gather_rows(one.expand(1, 4, 2 ** 5),
                       torch.zeros(1, 1, dtype=torch.int64, device=cuda).expand(1, 2 ** 26))
    with pytest.raises(ValueError, match="V // tile >= 3"):
        ef.fused_edge_mlp_windowed(*_edge_args(cuda, 32, V=256), tile_v=128)
    with pytest.raises(ValueError, match="k <= 8"):
        kf.knn_batched(q, c, 9, kmask)
    args, dout = _bwd_args(cuda, 48)
    with pytest.raises(ValueError, match="widths"):
        ef.fused_edge_mlp_bwd(*args, dout)
    args, dout = _bwd_args(cuda, 32)
    with pytest.raises(ValueError, match="dout"):
        ef.fused_edge_mlp_bwd(*args, dout.double())
    assert counts == (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_windowed.launches,
                      kf.knn_batched.launches, kf.knn_topk.launches, gf.gather_rows.launches)
    # the trainable tail refuses them in its forward, K1
    for args in (_edge_args(cuda, 48), _edge_args(cuda, 32, D=17)):
        a, b = (t.float().requires_grad_() for t in args[:2])
        with pytest.raises(ValueError, match="widths|degree"):
            ef.fused_edge_mlp_trainable(a, b, *args[2:])
    assert counts == (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_windowed.launches,
                      kf.knn_batched.launches, kf.knn_topk.launches, gf.gather_rows.launches)
    assert ef.fused_edge_mlp_bwd.launches == k6


# ---------------------------------------------------------------------------
# the row-invariant fp32 product KG
# ---------------------------------------------------------------------------

# KG sums each element's K products in fp32 in one fixed order: against the
# float64 product it is held to the worst case of recursive summation,
# K * 2^-24 times sum_k |a_k b_k| per element (so is torch.matmul, the plain
# version, in its own order).
KG_ULP = 2.0 ** -24
# phase 19's Dense layers that the split comparison named on cuBLAS,
# (rows of the whole batch, in, out): CorrNet's mesh encoder's
# vtx_gcu_4.mlp.dense_0 (B=4, V=2048), the motion trunk's gcu_2.mlp.dense_0
# (B=4, V=2048), BoneNet's joint_encoder.sa3.nn.dense_4 and RootNet's
# fp3.nn.dense_0 (12 samples' 10 rows); and the temporal attention's
# per-(sample, vertex, head) products (T+1 = 6 keyframe rows, 16 wide)
KG_DENSE_SHAPES = [(8192, 512, 512), (8192, 288, 256), (120, 256, 128), (120, 768, 256)]


def _kg_close(got, a, b, bias=None):
    ref = torch.matmul(a.double(), b.double())
    bound = torch.matmul(a.double().abs(), b.double().abs())
    if bias is not None:
        ref = ref + bias.double()
        bound = bound + bias.double().abs()
    K = a.shape[-1]
    return bool(((got.double() - ref).abs() <= (K + 1) * KG_ULP * bound).all())


@pytest.mark.parametrize("batch, M, N, K", [
    (None, 1, 1, 1), (None, 33, 65, 7), (None, 130, 257, 19), (None, 256, 128, 0),
    (3, 129, 31, 8), (3, 31, 129, 9), (5, 6, 6, 16), (None, 4, 1024, 1088),
    (2, 200, 300, 1000)])
@pytest.mark.parametrize("layout", ["rows", "transposed b", "shared b", "bias"])
def test_gemm_matches_float64(cuda, batch, M, N, K, layout):
    """KG against the float64 product at ragged M, N and K (partial
    128 x 128 tiles, a partial last 8-deep K step, K = 0), both routes
    (at least 32 rows and columns: the tile; else one thread per element),
    a batch, b given as a transposed view (a Dense weight), one b shared by
    the batch, a bias; within the recursive-summation bound, as the plain
    version (torch.matmul) is."""
    from morig_tpu_torch.kernels import gemm as kg

    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    lead = () if batch is None else (batch,)
    a = torch.randn(lead + (M, K), device=cuda, generator=g)
    if layout == "transposed b":
        b = torch.randn(lead + (N, K), device=cuda, generator=g).transpose(-1, -2)
    elif layout == "shared b":
        b = torch.randn(K, N, device=cuda, generator=g)
    else:
        b = torch.randn(lead + (K, N), device=cuda, generator=g)
    bias = torch.randn(N, device=cuda, generator=g) if layout == "bias" else None
    before = kg.gemm.launches
    got = kg.gemm(a, b, bias)
    plain = kg.gemm_plain(a, b, bias)
    torch.cuda.synchronize()
    assert kg.gemm.launches == before + 1
    assert got.shape == plain.shape and got.is_contiguous()
    assert _kg_close(got, a, b, bias) and _kg_close(plain, a, b, bias)


@pytest.mark.parametrize("M, K, N", KG_DENSE_SHAPES)
def test_gemm_rows_and_columns_do_not_depend_on_the_call(cuda, M, K, N):
    """Dense's product through KG (`kernels.gemm.linear`) at phase 19's
    shapes: each half of the rows (a data = 2 rank's), and each half of the
    output columns (a model = 2 rank's split layer), equal the whole call's
    bit for bit, in the forward and in the input gradient (dx = dy @ W);
    cuBLAS's product did not (the split comparison named these layers)."""
    from morig_tpu_torch.kernels import gemm as kg

    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, device=cuda, generator=g)
    w = torch.randn(N, K, device=cuda, generator=g) / math.sqrt(K)
    bias = torch.randn(N, device=cuda, generator=g)
    dy = torch.randn(M, N, device=cuda, generator=g)

    def run(x, w, bias, dy):
        x = x.clone().requires_grad_()
        y = kg.linear(x, w, bias)
        (dx,) = torch.autograd.grad(y, x, dy)
        return y, dx

    y, dx = run(x, w, bias, dy)
    h = M // 2
    for rows in (slice(0, h), slice(h, M)):
        y_r, dx_r = run(x[rows], w, bias, dy[rows])
        assert torch.equal(y_r, y[rows]) and torch.equal(dx_r, dx[rows])
    for cols in (slice(0, N // 2), slice(N // 2, N)):
        assert torch.equal(kg.linear(x, w[cols], bias[cols]), y[:, cols])
    assert _kg_close(y, x, w.t(), bias)


def test_gemm_routes_agree_bit_for_bit(cuda):
    """KG's three routes (the 128 x 128 tile where a batch of tiles fills
    the card, the 32 x 64 tile where one matrix does not, one thread per
    element for at most 64 elements) give the same bits for the same
    element, so a rank whose rows take another route than the whole batch's
    still computes them alike."""
    from morig_tpu_torch.kernels import gemm as kg

    g = torch.Generator(device=cuda).manual_seed(5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    a = torch.randn(sms, 64, 200, device=cuda, generator=g)
    b = torch.randn(200, 128, device=cuda, generator=g)
    bias = torch.randn(128, device=cuda, generator=g)
    big, mid = kg.gemm(a, b, bias), kg.gemm(a[0], b, bias)
    assert torch.equal(big[0], mid)
    for r in (0, 17, 63):
        assert torch.equal(kg.gemm(a[0, r:r + 1], b[:, :64], bias[:64]), mid[r:r + 1, :64])


def test_batched_gemm_rows_do_not_depend_on_the_batch(cuda):
    """The temporal attention's products through KG (`kernels.gemm.bmm`,
    (B*V*H, T+1, D) by (B*V*H, D, T+1) and back) on half of the batch equal
    the whole batch's bit for bit, and so do both gradients."""
    from morig_tpu_torch.kernels import gemm as kg

    g = torch.Generator(device=cuda).manual_seed(3)
    n = 4 * 2048 * 4
    q = torch.randn(n, 6, 16, device=cuda, generator=g)
    k = torch.randn(n, 16, 6, device=cuda, generator=g)
    dc = torch.randn(n, 6, 6, device=cuda, generator=g)

    def run(q, k, dc):
        q, k = q.clone().requires_grad_(), k.clone().requires_grad_()
        c = kg.bmm(q, k)
        return (c, *torch.autograd.grad(c, (q, k), dc))

    whole = run(q, k, dc)
    for part in (slice(0, n // 2), slice(n // 2, n)):
        for got, ref in zip(run(q[part], k[part], dc[part]), whole):
            assert torch.equal(got, ref[part])


@pytest.mark.parametrize("N", [2048, 48])
def test_masked_mean_rows_do_not_depend_on_the_batch(cuda, N):
    """The jointnet loss's per-sample masked mean (`losses.basic._masked_mean`
    over a creature's 2048 shifted vertices and its 48 joint slots, B = 4,
    the split comparison's second source on the card) through KG
    (`kernels.gemm.dot_last`): each half of the batch equals the whole
    batch's rows bit for bit, and so does its gradient."""
    from morig_tpu_torch.losses import basic

    g = torch.Generator(device=cuda).manual_seed(N)
    d = torch.rand(4, N, device=cuda, generator=g)
    mask = torch.rand(4, N, device=cuda, generator=g) < 0.8
    dy = torch.randn(4, device=cuda, generator=g)

    def run(d, mask, dy):
        d = d.clone().requires_grad_()
        y = basic._masked_mean(d, mask)
        return y, torch.autograd.grad(y, d, dy)[0]

    whole = run(d, mask, dy)
    for part in (slice(0, 2), slice(2, 4)):
        for got, ref in zip(run(d[part], mask[part], dy[part]), whole):
            assert torch.equal(got, ref[part])
    ref64 = (d.double() * mask).sum(-1) / mask.sum(-1).clamp(min=1)
    assert torch.allclose(whole[0].double(), ref64, rtol=(N + 2) * 2.0 ** -24, atol=0)


# K at the chunk's edges (1, KC - 1, KC, KC + 1, 2 KC + 3) and a global MLP's
# 1088; b as a Dense weight's W^T view (k-fast) and as dy @ W's W (n-fast)
KG_CHUNK_KS = (1, 63, 64, 65, 131, 1088)


def _kg_b(dev, K, N, layout, g):
    if layout == "weight view":
        return torch.randn(N, K, device=dev, generator=g).t()
    return torch.randn(K, N, device=dev, generator=g)


@pytest.mark.parametrize("K", KG_CHUNK_KS)
@pytest.mark.parametrize("layout", ["weight view", "n-fast"])
def test_gemm_forced_routes_agree_bit_for_bit(cuda, K, layout):
    """Every route and tile `kernels.gemm.plan` can be forced to (one
    thread per element; each tile walking all of K; each tile split one
    chunk a block, its partials folded by the second kernel) gives the
    planned call's bits at K on both sides of the chunk edges, ragged M and
    N included; and the planned call is within the summation bound."""
    from morig_tpu_torch.kernels import gemm as kg

    assert kg.KC == 64
    g = torch.Generator(device=cuda).manual_seed(K)
    a = torch.randn(70, K, device=cuda, generator=g)
    b = _kg_b(cuda, K, 136, layout, g)
    bias = torch.randn(136, device=cuda, generator=g)
    ref = kg.gemm(a, b, bias)
    for route in kg.ROUTES:
        for tile in ([None] if route == "tiny" else range(len(kg.TILES))):
            assert torch.equal(kg.gemm(a, b, bias, route=route, tile=tile), ref), (route, tile)
    assert _kg_close(ref, a, b, bias)


@pytest.mark.parametrize("M, K, N", KG_DENSE_SHAPES + [(4, 1088, 1024)])
@pytest.mark.parametrize("layout", ["weight view", "n-fast"])
def test_gemm_column_halves_equal_the_whole_call(cuda, M, K, N, layout):
    """A model = 2 rank's half of the output columns (b's half, the bias's
    half) equals those columns of the whole call bit for bit, whichever
    routes the two calls take, at phase 3's Dense shapes."""
    from morig_tpu_torch.kernels import gemm as kg

    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = torch.randn(M, K, device=cuda, generator=g)
    b = _kg_b(cuda, K, N, layout, g)
    bias = torch.randn(N, device=cuda, generator=g)
    whole = kg.gemm(a, b, bias)
    for cols in (slice(0, N // 2), slice(N // 2, N)):
        assert torch.equal(kg.gemm(a, b[:, cols], bias[cols]), whole[:, cols])


def test_gemm_split_route_replays_in_a_cuda_graph(cuda):
    """A split-route call (a global MLP's 4 x 1088 -> 1024: its workspace
    taken inside the capture) captured in a CUDA graph and replayed twice,
    on the captured inputs and on new ones copied into them, equals the
    eager call bit for bit; the capture counts one launch."""
    from morig_tpu_torch.kernels import gemm as kg

    g = torch.Generator(device=cuda).manual_seed(1088)
    a = torch.randn(4, 1088, device=cuda, generator=g)
    b = _kg_b(cuda, 1088, 1024, "weight view", g)
    bias = torch.randn(1024, device=cuda, generator=g)
    assert kg.plan(1, 4, 1024, 1088, kg.sm_count(cuda)).route == "split"
    eager = kg.gemm(a, b, bias)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kg.gemm(a, b, bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kg.gemm.launches
    with torch.cuda.graph(graph):
        out = kg.gemm(a, b, bias)
    assert kg.gemm.launches == before + 1
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    a.copy_(torch.randn(4, 1088, device=cuda, generator=g))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, kg.gemm(a, b, bias))


def test_gemm_refuses_what_it_does_not_take(cuda):
    """KG takes fp32 (batch,) M x K and K x N operands on one device; other
    types and shapes raise on a CUDA tensor and launch nothing."""
    from morig_tpu_torch.kernels import gemm as kg

    a, b = torch.randn(8, 4, device=cuda), torch.randn(4, 3, device=cuda)
    before = kg.gemm.launches
    with pytest.raises(TypeError, match="fp32"):
        kg.gemm(a.double(), b.double())
    with pytest.raises(TypeError, match="fp32"):
        kg.gemm(a.to(torch.bfloat16), b)
    with pytest.raises(ValueError):
        kg.gemm(a, b.t())
    with pytest.raises(ValueError, match="batches"):
        kg.gemm(a.expand(2, 8, 4), torch.randn(3, 4, 3, device=cuda))
    with pytest.raises(ValueError):
        kg.gemm(a, b, torch.zeros(4, device=cuda))
    assert kg.gemm.launches == before


# ---------------------------------------------------------------------------
# the "batch" norm mode on the card
# ---------------------------------------------------------------------------

# "batch" mode is fp32 throughout, on the card without TF32 as on the CPU, so
# the card and the CPU differ by fp32 sums in another order: outputs and
# statistics held at 1e-5 absolute and relative (MaskedBatchNorm) and 1e-4
# (a GCU: two edge layers, a max and a fuse MLP behind each output).
BN_TOL, GCU_BN_TOL = 1e-5, 1e-4


@pytest.fixture
def batch_mode():
    from morig_tpu_torch.nn import mlp

    prev = mlp.get_default_norm()
    mlp.set_default_norm("batch")
    yield
    mlp.set_default_norm(prev)


def _edge_counts():
    from morig_tpu_torch.nn import gcu

    return (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_windowed.launches,
            ef.fused_edge_mlp_bwd.launches, gcu.plain_edge.launches)


def _bn_close(got, ref, tol, what):
    err = (got.detach().cpu().double() - ref.detach().double()).abs()
    lim = tol + tol * ref.detach().double().abs()
    assert bool((err <= lim).all()), f"{what}: max abs err {err.max().item():.3g}"


@pytest.mark.parametrize("train", [False, True])
def test_masked_batch_norm_on_card_matches_cpu(cuda, train):
    """MaskedBatchNorm over an edge tensor (B, V, D, C) masked by (B, V, D),
    on the card and the CPU from the same statistics: the output, its input
    gradient and (in training) the updated running statistics."""
    import copy

    from morig_tpu_torch.nn.norm import MaskedBatchNorm

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 300, 12, 64, generator=g) * 2.0 + 0.5
    mask = torch.rand(2, 300, 12, generator=g) < 0.6
    dout = torch.randn(x.shape, generator=g)
    bn = MaskedBatchNorm(64)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.2, generator=g)
        bn.running_mean.normal_(0.0, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    bn_card = copy.deepcopy(bn).to(cuda)
    xs = [x.clone().requires_grad_(), x.to(cuda).requires_grad_()]
    ys = [bn(xs[0], mask, train), bn_card(xs[1], mask.to(cuda), train)]
    for y, d in zip(ys, (dout, dout.to(cuda))):
        y.backward(d)
    _bn_close(ys[1], ys[0], BN_TOL, "output")
    _bn_close(xs[1].grad, xs[0].grad, BN_TOL, "input gradient")
    for name in ("running_mean", "running_var"):
        _bn_close(getattr(bn_card, name), getattr(bn, name), 1e-6, name)


def _capsule_mesh(dev, B=2):
    from morig_tpu_torch.core.batch import stack_meshes
    from morig_tpu_torch.data.synthetic import capsule_batch

    entries, frames = capsule_batch(B, 5, 256, 512, 12, n_lat=17, n_lon=16)
    return entries, frames, stack_meshes(entries, dev)


def test_gcu_batch_mode_on_card_matches_cpu(cuda, batch_mode):
    """A GCU(64 -> 128) built in "batch" mode with seeded weights and
    statistics, on the card and the CPU: inference, and training with its
    updated running statistics.  No edge kernel (K1, K5, K6) and no
    `plain_edge` call runs."""
    import copy

    from morig_tpu_torch.nn import gcu
    from morig_tpu_torch.weights import randomize_

    _, _, mesh_card = _capsule_mesh(cuda)
    mesh = mesh_card.to("cpu")
    net = randomize_(gcu.GCU(64, 128), 5)
    net_card = copy.deepcopy(net).to(cuda)
    x = torch.randn(*mesh.verts.shape[:2], 64, generator=torch.Generator().manual_seed(4))
    vm = mesh.vert_mask
    before = _edge_counts()
    for train in (False, True):
        y = net(x, mesh, train=train)
        y_card = net_card(x.to(cuda), mesh_card, train=train)
        _bn_close(y_card[vm.to(cuda)], y[vm], GCU_BN_TOL, f"GCU train={train}")
    for (name, b), b_card in zip(net.named_buffers(), net_card.buffers()):
        _bn_close(b_card, b, GCU_BN_TOL, name)
    assert _edge_counts() == before


def test_predict_rig_batch_batch_mode_on_card(cuda, batch_mode):
    """One predict_rig_batch call in "batch" mode on the card (B=2 capsules
    of 290 vertices in 512, P=256, T=5): valid rigs, skin rows summing to 1,
    and the counts of one call: K2 3, K3 12, no edge kernel and no
    `plain_edge`."""
    import numpy as np

    from morig_tpu_torch.nn import gcu
    from morig_tpu_torch.pipelines.rig_predict import RigPredictor

    entries, frames, _ = _capsule_mesh(cuda)
    pred = RigPredictor.random(0, device=cuda)
    pred.predict_rig_batch(entries, frames)
    for c in (ef.fused_edge_mlp, ef.fused_edge_mlp_windowed, ef.fused_edge_mlp_bwd,
              kf.knn_batched, gf.gather_rows):
        c.launches = 0
    gcu.plain_edge.launches = 0
    rigs = pred.predict_rig_batch(entries, frames)
    torch.cuda.synchronize()
    assert _edge_counts() == (0, 0, 0, 0)
    assert (kf.knn_batched.launches, gf.gather_rows.launches) == (3, 12)
    for rig, e in zip(rigs, entries):
        assert len(rig.pos) >= 1 and np.isfinite(rig.pos).all()
        assert rig.skins.shape == (int(e["vert_mask"].sum()), len(rig.pos))
        if (rig.parents >= 0).any():
            assert np.abs(rig.skins.sum(1) - 1.0).max() <= 1e-3


def test_frozen_extractor_keeps_its_statistics_on_card(cuda, batch_mode):
    """A DeformPoseStage step in "batch" mode on the card with the extractor
    frozen: its parameters and running statistics stay as they were bit for
    bit, GCNDeform's running statistics move."""
    from morig_tpu_torch.data.pose import capsule_pose_dataset
    from morig_tpu_torch.train.stages import DeformPoseStage

    batch = capsule_pose_dataset(num_models=2, num_frames=3, num_points=128, n_lat=9,
                                 n_lon=8).batch([0, 1], 0, 2, device=cuda)
    stage = DeformPoseStage()
    state = stage.init_state(0, device=cuda)
    ext, comp = state.model.corr_extractor, state.model.completing
    before = [t.detach().clone() for t in list(ext.parameters()) + list(ext.buffers())]
    comp_stats = [b.clone() for b in comp.buffers()]
    m = stage.train_step(state, batch, torch.Generator(device=cuda).manual_seed(1))
    assert all(math.isfinite(v) for v in m.values()), m
    after = list(ext.parameters()) + list(ext.buffers())
    assert len(before) == len(after) and all(torch.equal(a, b) for a, b in zip(before, after))
    assert any(not torch.equal(a, b) for a, b in zip(comp_stats, comp.buffers()))


# ---------------------------------------------------------------------------
# Repeatable training: the ordered row scatter, K6 bit for bit, the K5
# trainable, and whole steps run twice
# ---------------------------------------------------------------------------

SCATTER_WIDTHS = (3, 16, 32, 64, 128, 256)
SCATTER_CASES = (["knn_vismask", "knn_values", "k6_tables", "crowded", "unaligned_f32",
                  "unaligned_bf16", "many_rows"]
                 + [f"{t}_{C}" for t in ("f32", "bf16") for C in SCATTER_WIDTHS])


def _scatter_case(dev, case):
    """(idx, rows, n, mask, route): K2's backward shapes (the vismask 1-NN:
    4 x 2048 vertex queries into 1024 points, 64 wide; the completion's k=3
    gather of 3-wide values), K6's training tables (B=4, V=2048, D=16, 1298
    valid rows, bf16 dx rows at H=256), a 1-NN of 2 x 4096 queries into 4
    candidates (some 2000 sources a target), rows whose base is one element
    off 16 bytes, fp32 and bf16 rows of each of SCATTER_WIDTHS channels with
    targets 96-127 of each batch row left without a source, and 40000
    targets of 256 bf16 channels (a 1-NN of 8 x 5000 rows into 5000, more
    warps than an H100 holds at once).  `route`: the one `plan_scatter` must
    give."""
    g = torch.Generator(device=dev).manual_seed(len(case))
    vector = "vector"
    if case == "knn_vismask":
        idx = torch.randint(0, 1024, (4, 2048, 1), device=dev, generator=g)
        return idx, torch.randn(4, 2048, 1, 64, device=dev, generator=g), 1024, None, vector
    if case == "knn_values":
        idx = torch.randint(0, 300, (4, 1024, 3), device=dev, generator=g)
        return idx, torch.randn(4, 1024, 3, 3, device=dev, generator=g), 300, None, "scalar"
    if case == "crowded":
        idx = torch.randint(0, 4, (2, 4096, 1), device=dev, generator=g)
        return idx, torch.randn(2, 4096, 1, 64, device=dev, generator=g), 4, None, vector
    if case.startswith("unaligned"):
        dtype = torch.float32 if case.endswith("f32") else torch.bfloat16
        idx = torch.randint(0, 96, (3, 200, 2), device=dev, generator=g)
        flat = torch.randn(3 * 200 * 2 * 64 + 1, device=dev, generator=g).to(dtype)
        return idx, flat[1:].view(3, 200, 2, 64), 128, None, "scalar"
    if case == "many_rows":
        idx = torch.randint(0, 5000, (8, 5000, 1), device=dev, generator=g)
        rows = torch.randn(8, 5000, 1, 256, device=dev, generator=g).to(torch.bfloat16)
        return idx, rows, 5000, None, vector
    if case != "k6_tables":
        kind, C = case.split("_")
        dtype = torch.float32 if kind == "f32" else torch.bfloat16
        idx = torch.randint(0, 96, (3, 200, 2), device=dev, generator=g)
        rows = torch.randn(3, 200, 2, int(C), device=dev, generator=g).to(dtype)
        return idx, rows, 128, None, "scalar" if C == "3" else vector
    B, V, D = 4, 2048, 16
    v = torch.arange(V, device=dev)[None, :, None]
    idx = (v + torch.randint(-20, 21, (B, V, D), device=dev, generator=g)).clamp(0, 1297)
    mask = torch.rand(B, V, D, device=dev, generator=g) < 0.8
    mask[:, 1298:] = False
    rows = torch.randn(B, V, D, 256, device=dev, generator=g).to(torch.bfloat16)
    return idx, rows, V, mask, vector


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_row_scatter_is_ordered(cuda, case):
    """The ordered row scatter against `index_add_`: on the card (atomics in
    no fixed order) within fp32 summation order, 1e-5 of the largest sum;
    against the CPU's `index_add_` (sequential, the kernel's order) and
    against itself run twice, bit for bit.  K6's case goes through the
    reverse table of a masked table and the kernel's bf16 rows, under both
    of the kernel's names (`edge_db`).  Each case takes the route its shape
    and alignment give, so both routes and every group width run."""
    idx, rows, n, mask, route = _scatter_case(cuda, case)
    C = rows.shape[-1]
    flat = rows.reshape(-1, C)
    p = gf.plan_scatter(idx.shape[0] * n, C, rows.element_size(), flat.data_ptr() % 16 == 0,
                        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert p.route == route
    before = gf.scatter_rows.launches
    if mask is None:
        got = [gf.scatter_rows(idx, rows, n) for _ in range(2)]
        assert gf.scatter_rows.launches == before + 2
    else:
        order, offsets = gf.reverse_table(idx, n, mask)
        again = gf.reverse_table(idx, n, mask)                   # built again, the same
        assert torch.equal(again[0], order) and torch.equal(again[1], offsets)
        got = [gf.row_scatter_launch(flat, order, offsets, idx.shape[0] * n,
                                     edge_db=edge_db).reshape(idx.shape[0], n, -1)
               for edge_db in (False, True)]
        rows = rows * mask[..., None]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    ref = gf.scatter_rows_plain(idx, rows, n)
    assert (got[0] - ref).abs().max() <= 1e-5 * max(ref.abs().max().item(), 1.0)
    assert torch.equal(got[0].cpu(), gf.scatter_rows_plain(idx.cpu(), rows.cpu(), n))


@pytest.mark.parametrize("case", ["knn_vismask", "bf16_16", "knn_values"])
def test_row_scatter_replays_from_a_cuda_graph(cuda, case):
    """`scatter_rows` (the reverse table's build and the kernel) captured in
    a CUDA graph and replayed on new rows of the same shape equals the eager
    call on them bit for bit: the launch depends on the shapes alone."""
    idx, rows, n, _, _ = _scatter_case(cuda, case)
    static = rows.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gf.scatter_rows(idx, static, n)                          # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gf.scatter_rows(idx, static, n)
    fresh = torch.randn(rows.shape, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(5)).to(rows.dtype)
    static.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, gf.scatter_rows(idx, fresh, n))
    assert torch.equal(out.cpu(), gf.scatter_rows_plain(idx.cpu(), fresh.cpu(), n))


def _training_tables(dev, H, D, seed, local=False):
    """K6's training tables: B=4, V=2048 with 1298 valid rows, degree D; with
    `local`, every neighbour inside its 128-vertex tile's window."""
    args = (_windowed_args(dev, H, D, 128, 2048, seed=seed, B=4, leave=False) if local
            else _edge_args(dev, H, B=4, V=2048, D=D, seed=seed))
    args[3][:, 1298:] = False
    dout = torch.randn(4, 2048, H, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    return args, dout


@pytest.mark.parametrize("H", WIDTHS)
def test_edge_mlp_bwd_repeats_bit_for_bit(cuda, H):
    """K6 twice on the training tables (D=16): every gradient, db_table
    included, equal bit for bit; and within the plain version's bounds."""
    args, dout = _training_tables(cuda, H, 16, seed=H)
    first = ef.fused_edge_mlp_bwd(*args, dout)
    again = ef.fused_edge_mlp_bwd(*args, dout)
    torch.cuda.synchronize()
    for name, x, y in zip(K6_NAMES, first, again):
        assert torch.equal(x, y), name
    assert_k6_close(first, ef.edge_mlp_bwd_plain(*args, dout))


@pytest.mark.parametrize("D", [12, 16])
@pytest.mark.parametrize("H", WIDTHS)
def test_k5_is_k6_recomputed_forward_on_local_tables(cuda, H, D):
    """The K5 trainable's invariant: on tables local at the tile (B=4,
    V=2048, TV=128, the training shapes), K5's output equals the forward K6
    recomputes (the max its route compares against) bit for bit."""
    args, dout = _training_tables(cuda, H, D, seed=H + D, local=True)
    k5 = ef.fused_edge_mlp_windowed(*args, tile_v=128)
    _, ymax = ef.fused_edge_mlp_bwd(*args, dout, return_forward=True)
    torch.cuda.synchronize()
    assert torch.equal(k5, ymax)


def test_windowed_trainable_launches_k5_and_k6(cuda):
    """fused_edge_mlp_trainable with a tile: forward K5 (counted there, not
    as K1), backward K6; on local tables its output and gradients equal the
    K1 trainable's bit for bit."""
    args, dout = _training_tables(cuda, 64, 16, seed=7, local=True)
    a, b, nbr, mask, *params = args
    runs = []
    for tile in (128, None):
        leaves = [t.detach().float().requires_grad_() for t in (a, b, *params)]
        before = (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_windowed.launches,
                  ef.fused_edge_mlp_bwd.launches)
        out = ef.fused_edge_mlp_trainable(leaves[0], leaves[1], nbr, mask, *leaves[2:],
                                          tile_v=tile)
        (out * dout).sum().backward()
        torch.cuda.synchronize()
        after = (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_windowed.launches,
                 ef.fused_edge_mlp_bwd.launches)
        assert tuple(x - y for x, y in zip(after, before)) == ((0, 1, 1) if tile else (1, 0, 1))
        runs.append([out.detach()] + [t.grad for t in leaves])
    for x, y in zip(*runs):
        assert torch.equal(x, y)


# The narrow route on the card (KN forward, KNB backward) against the same
# call on the CPU (their plain versions): both fp32 throughout, the products
# and the LayerNorm sums in other orders, so the outputs part in the last
# bits (the composite route before KN/KNB: below 1.8e-7).  Where that moves
# an input of the second ReLU across 0 or a near-tie of the max, the card's
# gradient for that edge and channel takes another route than the CPU's,
# which moves every gradient a little.  So a call is compared where the
# routing cannot differ: `narrow_edge.near_tie_vertices` finds, from the
# forward in float64, the vertices with a valid edge whose second ReLU input
# lies within NARROW_DELTA of 0 or a channel whose two largest distinct
# values among the valid edges lie within NARROW_DELTA (the first ReLU's
# input a + b is the same fp32 sum on both sides, and exact ties of
# duplicated neighbours compute alike); at most NARROW_NEAR_FRAC of the
# valid vertices (up to
# 5.1% on the training tables, at H = 8 and D = 16, counted on the CPU),
# their dout set to 0 on both sides; the output and every gradient then
# within NARROW_TOL relative L2 (measured up to 4.8e-7 at H = 16-64 on the
# H100).  At H = 8 a LayerNorm over 8 channels, most of them zeroed by the
# ReLU before it, can have a variance near 0, where its 1/sigma lifts the
# two sides' rounding: da and db within NARROW_TOL_8 there (measured 2.3e-5
# at D = 12).
NARROW_TOL, NARROW_TOL_8 = 1e-5, 1e-4
NARROW_DELTA, NARROW_NEAR_FRAC = 1e-5, 0.1
NARROW_NAMES = ("out", "da", "db", "dw2", "db2", "dg1", "dbe1", "dg2", "dbe2")


def narrow_near_ties(args):
    """`narrow_edge.near_tie_vertices` at NARROW_DELTA, on the CPU."""
    from morig_tpu_torch.kernels import narrow_edge as ne

    return ne.near_tie_vertices(*(t.detach().cpu() for t in args), delta=NARROW_DELTA)


def _narrow_side(dev, args, rev, dout):
    """One `narrow_edge_trainable` call (args: a, b, nbr, mask, w2, b2, g1,
    be1, g2, be2; rev: its reverse table) on `dev`: its output and the
    gradients of a, b, w2, b2, g1, be1, g2, be2, on the CPU."""
    from morig_tpu_torch.kernels import narrow_edge as ne

    leaves = [t.detach().to(dev).float().requires_grad_() if t.is_floating_point()
              else t.to(dev) for t in args]
    out = ne.narrow_edge_trainable(*leaves, rev=tuple(t.to(dev) for t in rev))
    out.backward(dout.to(dev))
    return [out.detach().cpu()] + [t.grad.cpu() for t in leaves if t.requires_grad]


def _narrow_card_against_cpu(cuda, args, rev, dout):
    """`_narrow_side` on the card and on the CPU with the near-tie vertices'
    dout at 0: (the relative L2 of the output and of each gradient; the
    near-tie vertices; the valid vertices)."""
    near = narrow_near_ties(args)
    kept = dout.cpu() * (~near)[..., None]
    got, ref = _narrow_side(cuda, args, rev, kept), _narrow_side(torch.device("cpu"), args, rev,
                                                                 kept)
    rel = [((x - y).norm() / y.norm().clamp_min(1e-30)).item() for x, y in zip(got, ref)]
    return rel, int(near.sum()), int(args[3].any(-1).sum())


def _narrow_counts():
    from morig_tpu_torch.kernels import gemm
    from morig_tpu_torch.kernels import narrow_edge as ne

    return (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_bwd.launches, gf.gather_rows.launches,
            gf.scatter_rows.launches, gemm.gemm.launches, ne.narrow_edge_fwd.launches,
            ne.narrow_edge_bwd.launches)


def _narrow_args(dev, H, D=16, seed=0):
    """K6's training tables (B=4, V=2048 with 1298 valid rows, degree D)
    with fp32 a, b and parameters, and a dout."""
    args, dout = _training_tables(dev, H, D, seed=seed)
    return tuple(t.float() if t.is_floating_point() else t for t in args), dout


@pytest.mark.parametrize("H", [16, 32, 64])
def test_narrow_edge_on_card_matches_cpu_and_repeats(cuda, H):
    """`narrow_edge_trainable`, the fp32 training tail of the edge layers
    narrower than 128, on K6's training tables (B=4, V=2048 with 1298 valid
    rows, D=16) over the table's masked reverse table: twice bit for bit on
    the card, one KN and one KNB launch a call and no K1, K6, K3, KS or KG;
    output and every gradient (a, b, W2, b2, both LayerNorms) of the same
    call on the CPU within NARROW_TOL relative L2 where the routing cannot
    differ (`_narrow_card_against_cpu`)."""
    from morig_tpu_torch.kernels import narrow_edge as ne

    args, dout = _narrow_args(cuda, H, seed=H)
    a, b, nbr, mask, *params = args
    rev = gf.reverse_table(nbr, nbr.shape[1], mask)
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in (a, b, *params)]
        before = _narrow_counts()
        out = ne.narrow_edge_trainable(leaves[0], leaves[1], nbr, mask, *leaves[2:], rev=rev)
        (out * dout).sum().backward()
        torch.cuda.synchronize()
        assert tuple(x - y for x, y in zip(_narrow_counts(), before)) == (0, 0, 0, 0, 0, 1, 1)
        runs.append([out.detach()] + [t.grad for t in leaves])
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    rel, near, valid = _narrow_card_against_cpu(cuda, args, rev, dout)
    rel = dict(zip(NARROW_NAMES, rel))
    print(f"narrow_edge H={H}: card against CPU, {near} of {valid} vertices near a tie, "
          f"relative L2 {rel}")
    assert near <= NARROW_NEAR_FRAC * valid, (near, valid)
    assert all(v <= NARROW_TOL for v in rel.values()), rel


@pytest.mark.parametrize("D", [4, 12, 16])
@pytest.mark.parametrize("H", [8, 16, 32, 64])
def test_narrow_kernels_match_plain(cuda, H, D):
    """KN and KNB against their plain versions on the card, on the training
    tables at degree D with neighbour column 1 a copy of column 0 (exact
    ties): KN's output within NARROW_TOL relative L2, KNB's recomputed
    forward equal to KN's output bit for bit (the invariant its route rests
    on), a second KNB call equal bit for bit, and every gradient within
    NARROW_TOL relative L2 (NARROW_TOL_8 at H = 8) where the routing cannot
    differ."""
    from morig_tpu_torch.kernels import narrow_edge as ne

    args, dout = _narrow_args(cuda, H, D=D, seed=H + D)
    nbr, mask = args[2].clone(), args[3].clone()
    nbr[:, :, 1], mask[:, :, 1] = nbr[:, :, 0], mask[:, :, 0]
    args = args[:2] + (nbr, mask) + args[4:]
    out = ne.narrow_edge_fwd(*args)
    grads, fwd = ne.narrow_edge_bwd(*args, dout, return_forward=True)
    again = ne.narrow_edge_bwd(*args, dout)
    torch.cuda.synchronize()
    assert torch.equal(fwd, out)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    ref = ne.narrow_edge_plain(*args)
    assert ((out - ref).norm() / ref.norm()).item() <= NARROW_TOL
    near = narrow_near_ties(args).to(cuda)
    assert int(near.sum()) <= NARROW_NEAR_FRAC * int(mask.any(-1).sum())
    kept = dout * (~near)[..., None]
    got, ref = ne.narrow_edge_bwd(*args, kept), ne.narrow_edge_bwd_plain(*args, kept)
    tol = NARROW_TOL_8 if H == 8 else NARROW_TOL
    for name, x, y in zip(NARROW_NAMES[1:], got, ref):
        rel = ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
        print(f"KNB H={H} D={D} {name}: relative L2 {rel:.3g}")
        assert torch.isfinite(x).all() and rel <= tol, (name, rel)


def test_narrow_kernel_rows_do_not_depend_on_the_batch(cuda):
    """KN's output, KNB's da and db_table rows of each batch row alone (B =
    1) equal the whole batch's rows bit for bit: a vertex's rows do not
    depend on B, on the padding or on the grid (the row invariance of the
    data-parallel split, parallel/steps.py)."""
    from morig_tpu_torch.kernels import narrow_edge as ne

    args, dout = _narrow_args(cuda, 64, seed=5)
    out = ne.narrow_edge_fwd(*args)
    da, db = ne.narrow_edge_bwd(*args, dout)[:2]
    for i in range(args[0].shape[0]):
        part = tuple(t[i:i + 1] if t.dim() == 3 else t for t in args)
        assert torch.equal(ne.narrow_edge_fwd(*part), out[i:i + 1])
        got = ne.narrow_edge_bwd(*part, dout[i:i + 1])
        assert torch.equal(got[0], da[i:i + 1]) and torch.equal(got[1], db[i:i + 1])


def test_narrow_kernels_replay_in_a_cuda_graph(cuda):
    """The narrow tail forward and backward (KN, KNB and its scatter over a
    given reverse table) captured in one CUDA graph and replayed, on the
    captured inputs and on new ones copied into them, equal the eager calls
    bit for bit; the capture counts one KN and one KNB launch."""
    from morig_tpu_torch.kernels import narrow_edge as ne

    args, dout = _narrow_args(cuda, 32, seed=9)
    rev = gf.reverse_table(args[2], args[2].shape[1], args[3])

    def step():
        return (ne.narrow_edge_fwd(*args),) + ne.narrow_edge_bwd(*args, dout, rev=rev)

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (ne.narrow_edge_fwd.launches, ne.narrow_edge_bwd.launches)
    with torch.cuda.graph(graph):
        outs = step()
    assert (ne.narrow_edge_fwd.launches, ne.narrow_edge_bwd.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(outs, eager))
    args[0].copy_(torch.randn_like(args[0]))
    dout.copy_(torch.randn_like(dout))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(outs, step()))


def test_narrow_kernels_refuse_what_they_do_not_take(cuda):
    """KN and KNB raise on a CUDA tensor at a width outside NARROW_WIDTHS,
    a degree above 16 or bf16 inputs; nothing falls back to the plain
    version."""
    from morig_tpu_torch.kernels import narrow_edge as ne

    args, dout = _narrow_args(cuda, 12, D=4)
    with pytest.raises(ValueError, match="equal widths"):
        ne.narrow_edge_fwd(*args)
    with pytest.raises(ValueError, match="equal widths"):
        ne.narrow_edge_bwd(*args, dout)
    args, dout = _narrow_args(cuda, 16, D=4)
    wide = torch.cat([args[2]] * 5, -1), torch.cat([args[3]] * 5, -1)
    with pytest.raises(ValueError, match="degree"):
        ne.narrow_edge_fwd(args[0], args[1], *wide, *args[4:])
    with pytest.raises(TypeError, match="fp32"):
        ne.narrow_edge_fwd(args[0].to(torch.bfloat16), *args[1:])


def _repro_stages(dev):
    """The seven training steps at small sizes: (name, stage factory, batch,
    norm mode of the networks)."""
    from morig_tpu_torch.data.creature import creature_rig_dataset
    from morig_tpu_torch.data.pose import capsule_pose_dataset
    from morig_tpu_torch.data.skeleton_data import capsule_skel_dataset
    from morig_tpu_torch.train.stages import (BoneStage, CorrPoseStage, DeformPoseStage,
                                              RigStage, RootStage, SkinStage)

    def corr():
        stage = CorrPoseStage()
        stage.train_vismask = True
        return stage

    pose = capsule_pose_dataset(num_models=2, num_frames=4, num_points=256, n_lat=17,
                                n_lon=16).batch([0, 1], 0, 2, device=dev)
    rig = creature_rig_dataset(num_models=2, seed=0, num_points=64,
                               target_verts=600).batch([0, 1], device=dev)
    skel = capsule_skel_dataset(2, max_joints=8, num_points=64, n_lat=9, n_lon=8, device=dev)
    return [("corr", corr, pose, "layer"), ("deform", DeformPoseStage, pose, "layer"),
            ("rig jointnet", lambda: RigStage(arch="jointnet"), rig, "layer"),
            ("skin", SkinStage, rig, "layer"), ("bone", BoneStage, skel, "layer"),
            ("root", RootStage, skel, "layer"), ("corr batch mode", corr, pose, "batch")]


def test_training_steps_repeat_bit_for_bit(cuda):
    """Each of the seven training steps (CorrPoseStage, DeformPoseStage,
    RigStage jointnet, SkinStage, BoneStage, RootStage, and CorrPoseStage in
    "batch" norm mode), a seeded init and two steps, run twice on the card:
    every loss, gradient, parameter and running statistic equal bit for
    bit.  A failure names the stage and the first tensor that differs."""
    from morig_tpu_torch.nn import mlp
    from morig_tpu_torch.train.repro import first_difference, run_steps

    differing = {}
    prev = mlp.get_default_norm()
    try:
        for name, make, batch, norm in _repro_stages(cuda):
            mlp.set_default_norm(norm)
            runs = [run_steps(make(), batch, 2, device=cuda) for _ in range(2)]
            first = first_difference(*runs)
            if first is not None:
                differing[name] = first
    finally:
        mlp.set_default_norm(prev)
    assert not differing, differing


def _scan_runs(dev, make, loop, batcher, epochs, chunk):
    """run_epochs and run_epochs_scanned on the card from the same weights,
    generator and schedule draws: {runner: (weights and buffers, best epoch,
    logged (epoch, split, metrics), the scanned run's stats)}."""
    import numpy as np

    from morig_tpu_torch.train import scanned, trainer

    class Records(trainer.MetricLogger):
        def __init__(self):
            super().__init__(None)
            self.records = []

        def log(self, epoch, split, metrics, time_s=None, **extra):
            self.records.append((epoch, split, metrics))

    out = {}
    for runner in ("loop", "scan"):
        stage = make()
        state = stage.init_state(0, device=dev)
        logger, stats = Records(), {}
        gen, rng_np = torch.Generator(device=dev).manual_seed(3), np.random.default_rng(7)
        if runner == "loop":
            state, best = trainer.run_epochs(stage, state, lambda e: loop(rng_np, True),
                                             lambda: loop(rng_np, False), None, epochs,
                                             logger=logger, generator=gen)
        else:
            state, best = scanned.run_epochs_scanned(stage, state, batcher, epochs=epochs,
                                                     logger=logger, generator=gen,
                                                     rng_np=rng_np, chunk_epochs=chunk,
                                                     stats=stats)
        out[runner] = ([t.detach().clone() for t in (*state.model.parameters(),
                                                      *state.model.buffers())],
                       best, logger.records, stats)
    return out


def test_scanned_run_on_card_equals_the_loop(cuda):
    """BoneStage, RigStage jointnet, SkinStage and DeformPoseStage (the
    extractor frozen) on capsule data, on the card: run_epochs_scanned (each
    step a CUDA-graph replay, one host fetch per chunk) against run_epochs:
    the final weights and buffers, the best epoch and the logged metrics
    equal bit for bit (one step and one val batch per epoch, so the means
    are the values)."""
    from morig_tpu_torch.data.pose import capsule_pose_dataset
    from morig_tpu_torch.data.rig import capsule_rig_dataset
    from morig_tpu_torch.data.skeleton_data import capsule_skel_dataset
    from morig_tpu_torch.train import scanned
    from morig_tpu_torch.train.stages import BoneStage, DeformPoseStage, RigStage, SkinStage

    skel = capsule_skel_dataset(2, max_joints=8, num_points=64, n_lat=9, n_lon=8, device=cuda)
    rig = capsule_rig_dataset(num_models=2, num_points=64, n_lat=9, n_lon=8)
    pose = capsule_pose_dataset(num_models=2, num_frames=4, num_points=64, n_lat=9, n_lon=8)

    def skel_loop(rng, train):
        yield skel

    rig_loop = lambda rng, train: rig.epoch_batches(rng, 2, train, device=cuda)
    cases = [(BoneStage, skel_loop, scanned.const_scan_batcher(skel), 4, 3),
             (lambda: RigStage(arch="jointnet", num_embed_sample=32), rig_loop,
              scanned.rig_scan_batcher(rig, 2, device=cuda), 3, 2),
             (lambda: SkinStage(num_embed_sample=32), rig_loop,
              scanned.rig_scan_batcher(rig, 2, device=cuda), 3, 2),
             (DeformPoseStage,
              lambda rng, train: pose.epoch_batches(rng, 2, "modelsresource", False, train,
                                                    device=cuda),
              scanned.pose_scan_batcher(pose, 2, "modelsresource", False, device=cuda), 3, 2)]
    for make, loop, batcher, epochs, chunk in cases:
        runs = _scan_runs(cuda, make, loop, batcher, epochs, chunk)
        (lw, lb, lr, _), (sw, sb, sr, st) = runs["loop"], runs["scan"]
        assert st["captures"] == 1 and st["fetches"] == st["chunks"] == 2
        assert lb == sb and lr == sr
        assert all(torch.equal(a, b) for a, b in zip(lw, sw))


def test_failed_capture_raises(cuda):
    """A train step that reads a value on the host (`.item()`) cannot be
    captured: run_epochs_scanned on a CUDA state raises, naming the train
    program, and runs no eager loop in its place.  In a process of its own,
    since a failed capture may leave the card's context unusable."""
    import os
    import subprocess
    import sys

    code = """
import torch
from morig_tpu_torch.data.skeleton_data import capsule_skel_dataset
from morig_tpu_torch.train import scanned
from morig_tpu_torch.train.stages import BoneStage

class Syncing(BoneStage):
    def train_step(self, state, batch, generator=None, mesh=None, on_device=False):
        m = super().train_step(state, batch, generator, mesh, on_device)
        m["host"] = torch.tensor(float(m["total_loss"].item()), device=batch.joints.device)
        return m

dev = torch.device("cuda", 0)
skel = capsule_skel_dataset(2, max_joints=8, num_points=64, n_lat=9, n_lon=8, device=dev)
stage = Syncing()
state = stage.init_state(0, device=dev)
stats = {}
try:
    scanned.run_epochs_scanned(stage, state, scanned.const_scan_batcher(skel), epochs=2,
                               chunk_epochs=2, stats=stats)
except RuntimeError as err:
    assert "CUDA graph capture of the train program failed" in str(err), err
    assert stats["chunks"] == 0 and stats["steps"] == 0, stats
    print("raised")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root, env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("raised"), res.stdout + res.stderr
