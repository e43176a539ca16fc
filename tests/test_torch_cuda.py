"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and one training step on the card against the same step on the CPU.

Marked `gpu`: every test takes the `cuda` fixture, which skips when
torch.cuda.is_available() is false, so on a CPU host they all skip.  On a
machine with a card (and no jax) run them without the jax-importing
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Small shapes with the edge cases the main path can produce: rows with no
valid edge, ragged vertex tiles, duplicate and masked kNN candidates, rows
with fewer valid candidates than k, and for the windowed edge kernel K5
neighbours outside their window (a zero row) at every width, in both of its
modes (window staged in shared memory at H <= 64, read from global memory
at H >= 128), and for the edge backward K6 exact ties in the max (a
duplicated neighbour column) and rows with no valid edge.  Shapes and types
a kernel does not take raise on a CUDA tensor instead of falling back.
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


def test_trainable_tail_on_card_matches_cpu_plain(cuda):
    """Gradients through fused_edge_mlp_trainable (K1 forward, K6 backward)
    on the card against the same Function on the CPU (plain versions)."""
    args, dout = _bwd_args(cuda, 128, seed=5)
    a, b, nbr, mask, *params = args
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().float().to(dev).requires_grad_() for t in (a, b, *params)]
        out = ef.fused_edge_mlp_trainable(leaves[0], leaves[1], nbr.to(dev), mask.to(dev),
                                          *leaves[2:])
        (out * dout.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    torch.cuda.synchronize()
    assert_k6_close(grads[0], grads[1])


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


def _windowed_args(dev, H, D, TV, V, seed):
    """_edge_args with tables local to each vertex tile's window, except for
    a few valid neighbours that leave it."""
    a, b, _, mask, *rest = _edge_args(dev, H, V=V, D=D, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    v = torch.arange(V, device=dev)
    ws = ((v // TV - 1).clamp(0, V // TV - 3) * TV)[None, :, None]
    nbr = ws + torch.randint(0, 3 * TV, (2, V, D), device=dev, generator=g)
    nbr[0, :TV, 1] = V - 1                      # outside tile 0's window
    mask[0, 8:TV, 1] = True                     # (row 7 keeps no valid edge)
    return a, b, nbr, mask, *rest


@pytest.mark.parametrize("D", [12, 16])
@pytest.mark.parametrize("H", [16, 32, 64, 128, 256])
def test_edge_mlp_windowed_kernel_matches_plain(cuda, H, D):
    TV, V = 128, 640
    args = _windowed_args(cuda, H, D, TV, V, seed=H + D)
    before = (ef.fused_edge_mlp_windowed.launches, ef.fused_edge_mlp.launches)
    got = ef.fused_edge_mlp_windowed(*args, tile_v=TV)
    ref = ef.edge_mlp_windowed_plain(*args, tile_v=TV)
    torch.cuda.synchronize()
    assert (ef.fused_edge_mlp_windowed.launches, ef.fused_edge_mlp.launches) == (
        before[0] + 1, before[1])
    err = (got - ref).abs()
    assert err.max().item() <= K1_TOL and err.mean().item() <= K1_MEAN_TOL
    assert (got[:, 7] == 0).all() and (got[1, -1] == 0).all()
    # where every neighbour is in its window K5 equals K1's plain version
    full = ef.edge_mlp_plain(*args)
    assert ((got - full).abs()[1].max().item() <= K1_TOL
            and not torch.allclose(got[0, :TV], full[0, :TV]))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("C", [1, 3, 67, 256])
def test_gather_kernel_is_exact(cuda, C, dtype):
    g = torch.Generator(device=cuda).manual_seed(C)
    values = (torch.randn(3, 97, C, device=cuda, generator=g) * 1e3).to(dtype)
    idx = torch.randint(0, 97, (3, 41, 7), device=cuda, generator=g)
    before = gf.gather_rows.launches
    got = gf.gather_rows(values, idx)
    assert gf.gather_rows.launches == before + 1
    assert torch.equal(got, gf.gather_plain(values, idx))


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
    assert ef.fused_edge_mlp_bwd.launches == k6
