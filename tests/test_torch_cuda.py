"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
at H >= 128).  Shapes and types a kernel does not take
raise on a CUDA tensor instead of falling back.
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
    assert counts == (ef.fused_edge_mlp.launches, ef.fused_edge_mlp_windowed.launches,
                      kf.knn_batched.launches, kf.knn_topk.launches, gf.gather_rows.launches)
