"""morig_tpu_torch's analysis modules against morig_tpu's on the same numpy
inputs: rigid registration (Kabsch, ICP, piecewise RANSAC), kernel
k-means, the auxiliary losses and the segmentation helpers.

Where the JAX functions draw with jax.random inside, the port draws apart
from the computation, so each test hands the port JAX's draws: the RANSAC
hypotheses (`PiecewiseRansac.draw` replaced by JAX's key-split randint
sequence), the k-means initial centroids (`kernel_kmeans_from`) and the
rows each sampled loss uses (its `*_drawn` form).  Tolerances: fp32 on
both sides, 1e-5 for Kabsch and the losses' values and gradients, equal
for the discrete results.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import assert_close

from morig_tpu.data.synthetic import make_capsule_rig
from morig_tpu.geometry import kmeans as jkm
from morig_tpu.geometry import registration as jreg
from morig_tpu.geometry import segmentation as jseg
from morig_tpu.geometry import skeleton as jsk
from morig_tpu.losses import extras as jex
from morig_tpu_torch.geometry import kmeans as tkm
from morig_tpu_torch.geometry import registration as treg
from morig_tpu_torch.geometry import segmentation as tseg
from morig_tpu_torch.geometry import skeleton as tsk
from morig_tpu_torch.losses import extras as tex

TOL = 1e-5


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    1).reshape(n, 3, 3)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_matches_jax(weighted):
    """Batched (2, 3) fits of noisy rigid motions, optionally weighted, and
    one reflection-prone case (a planar cloud): R and t within 1e-5."""
    rng = np.random.default_rng(int(weighted))
    src = rng.normal(size=(2, 3, 20, 3)).astype(np.float32)
    src[1, 2, :, 2] = 0.0
    R = _rotations(rng, 6).reshape(2, 3, 3, 3)
    tar = (np.einsum("xkij,xknj->xkni", R, src) + rng.normal(size=(2, 3, 1, 3))
           + 0.01 * rng.normal(size=src.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, src.shape[:-1]).astype(np.float32) if weighted else None
    got = treg.kabsch(torch.as_tensor(src), torch.as_tensor(tar),
                      None if w is None else torch.as_tensor(w))
    ref = jreg.kabsch(jnp.asarray(src), jnp.asarray(tar), None if w is None else jnp.asarray(w))
    for g, r, what in zip(got, ref, ("R", "t")):
        assert_close(g, np.asarray(r), atol=TOL, what=what)
    np.testing.assert_allclose(torch.linalg.det(got[0]).numpy(), 1.0, atol=1e-5)
    for g, r in zip(treg.icp_numpy(src[0], tar[0], device="cpu"), jreg.icp_numpy(src[0], tar[0])):
        assert g.dtype == np.float32
        assert_close(g, r, atol=TOL, what="icp")


def test_registration_runs_on_the_card_by_default():
    """`icp_numpy` and `PiecewiseRansac` default to the card: on a host
    without one they raise rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    src = np.random.default_rng(0).normal(size=(1, 8, 3)).astype(np.float32)
    with pytest.raises((AssertionError, RuntimeError)):
        treg.icp_numpy(src, src)
    with pytest.raises((AssertionError, RuntimeError)):
        treg.PiecewiseRansac()


def _jax_draws(seed, num_hypotheses, sample_size):
    """PiecewiseRansac.draw replaced by the JAX package's draws: its key
    split, then randint, per fitted segment."""
    key = jax.random.key(seed)

    def draw(n):
        nonlocal key
        key, sub = jax.random.split(key)
        idx = jax.random.randint(sub, (num_hypotheses, min(sample_size, n)), 0, n)
        return torch.tensor(np.asarray(idx), dtype=torch.int64)
    return draw


def test_piecewise_ransac_matches_jax_on_its_hypotheses():
    """Three rigid segments with 30% outlier handles, fitted from JAX's
    hypotheses: the same consensus (deformed vertices within 1e-5), one
    segment with too few handles left in place."""
    rng = np.random.default_rng(4)
    V = 90
    verts = rng.normal(size=(V, 3)).astype(np.float32)
    segments = np.repeat(np.arange(3), V // 3)
    R = _rotations(rng, 3)
    srcs, tars, segs = [], [], []
    for s, n in ((0, 25), (1, 30), (2, 2)):
        src = rng.normal(size=(n, 3))
        tar = src @ R[s].T + rng.normal(size=3)
        bad = rng.random(n) < 0.3
        tar[bad] += rng.normal(scale=0.5, size=(bad.sum(), 3))
        srcs.append(src), tars.append(tar), segs.append(np.full(n, s))
    args = (verts, segments, np.concatenate(srcs).astype(np.float32),
            np.concatenate(tars).astype(np.float32), np.concatenate(segs))
    ref = jreg.PiecewiseRansac(num_hypotheses=32, seed=3).run(*args)
    port = treg.PiecewiseRansac(num_hypotheses=32, seed=3, device="cpu")
    port.draw = _jax_draws(3, 32, 4)
    got = port.run(*args)
    assert_close(got, ref, atol=TOL, what="ransac")
    np.testing.assert_array_equal(got[segments == 2], verts[segments == 2])
    own = treg.PiecewiseRansac(num_hypotheses=32, seed=3, device="cpu")
    assert own.draw(7).shape == (32, 4) and int(own.draw(2).max()) < 2
    assert np.isfinite(own.run(*args)).all()


def test_kernel_kmeans_matches_jax_from_its_initialization():
    """Four blobs of feature/position points with padded rows, from the
    centroids JAX's categorical draw picks: the same assignments."""
    rng = np.random.default_rng(5)
    centres = rng.normal(scale=3.0, size=(4, 8))
    lab = rng.integers(0, 4, 120)
    feats = (centres[lab] + 0.3 * rng.normal(size=(120, 8))).astype(np.float32)
    pos = (centres[lab, :3] + 0.2 * rng.normal(size=(120, 3))).astype(np.float32)
    mask = rng.random(120) > 0.1
    key = jax.random.key(9)
    init = jax.random.categorical(key, jnp.where(jnp.asarray(mask), 0.0, -1e30), shape=(6,))
    ref = jkm.kernel_kmeans(jnp.asarray(feats), jnp.asarray(pos), 6, key, 1.0, 0.5, 20,
                            jnp.asarray(mask))
    got = tkm.kernel_kmeans_from(torch.as_tensor(feats), torch.as_tensor(pos),
                                 torch.tensor(np.asarray(init), dtype=torch.int64), 1.0, 0.5,
                                 20, torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    own = tkm.kernel_kmeans(torch.as_tensor(feats), torch.as_tensor(pos), 6,
                            torch.Generator().manual_seed(0), mask=torch.as_tensor(mask))
    assert own.shape == (120,) and int(own.max()) < 6
    init_own = tkm.draw_kmeans_init(torch.Generator().manual_seed(1), torch.as_tensor(mask), 50)
    assert mask[init_own.numpy()].all()


# ---------------------------------------------------------------------------
# auxiliary losses
# ---------------------------------------------------------------------------

def _jax_rows(key, vert_mask, n):
    """The rows a JAX sampled loss draws: per sample, choice without
    replacement over the valid vertices, from split(key, B)."""
    def per_sample(k, m):
        p = m.astype(jnp.float32)
        return jax.random.choice(k, m.shape[0], (n,), replace=False, p=p / jnp.maximum(p.sum(), 1))
    ids = jax.vmap(per_sample)(jax.random.split(key, vert_mask.shape[0]), jnp.asarray(vert_mask))
    return torch.tensor(np.asarray(ids), dtype=torch.int64)


def _check_loss(torch_fn, jax_fn, inputs, what):
    """Value and gradient of the first input of torch_fn(*tensors) against
    jax.value_and_grad of jax_fn, within TOL relative to the reference."""
    t = [torch.tensor(x, requires_grad=(i == 0)) for i, x in enumerate(inputs)]
    val = torch_fn(*t)
    val.backward()
    ref, ref_grad = jax.value_and_grad(jax_fn)(*[jnp.asarray(x) for x in inputs])
    scale = max(float(abs(ref)), 1.0)
    assert abs(val.item() - float(ref)) <= TOL * scale, (what, val.item(), float(ref))
    g = np.asarray(ref_grad)
    assert_close(t[0].grad, g, atol=TOL * max(np.abs(g).max(), 1e-3), what=f"{what} grad")


def _skin_inputs(rng, B=2, V=300, C=16, J=6):
    f = rng.normal(size=(B, V, C)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    skin = rng.random((B, V, J)) ** 4
    skin[:, ::7] = skin[:, 3:4]                       # rows with equal skins
    skin = (skin / skin.sum(-1, keepdims=True)).astype(np.float32)
    mask = rng.random((B, V)) > 0.05
    return f, skin, mask


def test_sampled_losses_match_jax_on_its_draws():
    rng = np.random.default_rng(6)
    f, skin, mask = _skin_inputs(rng)
    key = jax.random.key(2)
    ids = _jax_rows(key, mask, 50)
    _check_loss(lambda x, s: tex.log_ratio_loss_drawn(x, s, ids),
                lambda x, s: jex.log_ratio_loss(key, x, s, jnp.asarray(mask)), (f, skin),
                "log_ratio")
    ids = _jax_rows(key, mask, 256)
    _check_loss(lambda x, s: tex.hinge_embedding_loss_drawn(x, s, ids),
                lambda x, s: jex.hinge_embedding_loss(key, x, s, jnp.asarray(mask)), (f, skin),
                "hinge")
    pred = rng.random(skin.shape).astype(np.float32)
    ids = _jax_rows(key, mask, int(skin.shape[1] * 0.25))
    _check_loss(lambda p, s: tex.skin_difference_loss_drawn(p, s, ids),
                lambda p, s: jex.skin_difference_loss(key, p, s, jnp.asarray(mask)), (pred, skin),
                "skin_difference")
    gen = torch.Generator().manual_seed(0)
    t = [torch.as_tensor(x) for x in (f, skin, mask)]
    for fn in (tex.log_ratio_loss, tex.hinge_embedding_loss):
        assert torch.isfinite(fn(gen, *t))
    assert torch.isfinite(tex.skin_difference_loss(gen, torch.as_tensor(pred), t[1], t[2]))


def test_segment_losses_match_jax():
    rng = np.random.default_rng(7)
    B, N, K = 2, 24, 4
    f = rng.normal(size=(B, N, 8)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    seg = np.eye(K, dtype=np.float32)[rng.integers(0, K, (B, N))]
    mask = rng.random((B, N)) > 0.2
    _check_loss(lambda x, s: tex.multi_label_bce(x, s, torch.as_tensor(mask)),
                lambda x, s: jex.multi_label_bce(x, s, jnp.asarray(mask)), (f, seg), "bce")
    for shape in ((B, N, N), (B, N, N, 3)):
        cost = rng.random(shape).astype(np.float32)
        _check_loss(lambda c, s: tex.trans_loss(c, s, torch.as_tensor(mask)),
                    lambda c, s: jex.trans_loss(c, s, jnp.asarray(mask)), (cost, seg),
                    f"trans {len(shape)}d")
    Rs = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1)) + 0.05 * rng.normal(
        size=(B, N, 3, 3)).astype(np.float32)
    ts, xyz, flow = (rng.normal(size=(B, N, 3)).astype(np.float32) for _ in range(3))
    _check_loss(lambda r, *a: tex.motion_loss(r, *a), jex.motion_loss, (Rs, ts, xyz, flow, seg),
                "motion")
    support = rng.normal(size=(B, N, N)).astype(np.float32)
    _check_loss(tex.grouping_loss, jex.grouping_loss, (support, seg), "grouping")
    soft = rng.random((N, 5)).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    match = jex.hungarian_matching(soft, seg[0])
    np.testing.assert_array_equal(tex.hungarian_matching(soft, seg[0]), match)
    # jax.grad cannot trace the JAX iou_loss (its matching reads the values
    # on the host): its gradient is taken with the matching it makes held
    # fixed, the loss after the matching written as in morig_tpu
    def jax_iou_after_match(p, g):
        p, g = p[:, match[0]], g[:, match[1]]
        inter = jnp.sum(p * g, axis=0)
        return jnp.mean(1.0 - inter / (jnp.sum(p, axis=0) + jnp.sum(g, axis=0) - inter + 1e-8))

    assert float(jex.iou_loss(jnp.asarray(soft), jnp.asarray(seg[0]))) == float(
        jax_iou_after_match(soft, seg[0]))
    _check_loss(tex.iou_loss, jax_iou_after_match, (soft, seg[0]), "iou")


def test_segmentation_helpers_equal():
    cap = make_capsule_rig(13, 12)
    kw = dict(names=list(cap.names), pos=cap.joints.astype(float), parents=cap.parents,
              skins=cap.skins)
    labels = np.argmax(cap.skins, axis=1)
    verts = cap.verts + np.array([0.03, 0.0, 0.0])        # off the symmetry plane
    np.testing.assert_array_equal(tseg.tpl_adjacency(len(verts), cap.faces),
                                  jseg.tpl_adjacency(len(verts), cap.faces))
    assert tseg.segment_compactness_side(labels, verts) == jseg.segment_compactness_side(
        labels, verts)
    np.testing.assert_array_equal(tseg.mirror_segmentation(labels, verts, cap.faces),
                                  jseg.mirror_segmentation(labels, verts, cap.faces))
    a, b = verts[labels == 0], verts[labels == 1]
    np.testing.assert_array_equal(tseg.boundary_pivot(a, b), jseg.boundary_pivot(a, b))
    np.testing.assert_array_equal(tseg.boundary_pivot(a, b[:0]), jseg.boundary_pivot(a, b[:0]))
    got = tseg.move_joints_to_boundary(tsk.Rig(**kw), verts, labels)
    ref = jseg.move_joints_to_boundary(jsk.Rig(**kw), verts, labels)
    assert isinstance(got, tsk.Rig)
    np.testing.assert_array_equal(got.pos, ref.pos)
    np.testing.assert_array_equal(got.parents, ref.parents)
