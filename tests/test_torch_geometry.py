"""The port's voxel, geodesic and vertex-order code against the JAX package.

Host copies (voxelization, RCM order) must give the JAX package's arrays
exactly; surface geodesics to 1e-6 relative, since the JAX package builds
the shared C++ Dijkstra with -march=native (fused multiply-adds) and the
port with portable flags, so path sums differ in the last fp32 bit.  The device functions run batched over meshes in
the port and per mesh (vmapped or looped) in JAX; containment and segment
inside-fractions must agree exactly, the volumetric geodesics to fp32
rounding (the straight distances are fp32 norms summed in another order;
everything downstream of them, the bf16 min-plus included, is the same
arithmetic).  Also the edge dispatch: a shuffled capsule goes to the
full-table kernel, the same capsule after the RCM order to the windowed one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.data import preprocess as jpre
from morig_tpu.geometry import geodesic as jgeo
from morig_tpu.geometry import voxel as jvox
from morig_tpu_torch.core.batch import build_mesh
from morig_tpu_torch.data import preprocess as tpre
from morig_tpu_torch.data.synthetic import make_capsule_rig
from morig_tpu_torch.geometry import geodesic as tgeo
from morig_tpu_torch.geometry.bones import point_to_segment_dist
from morig_tpu_torch.geometry import voxel as tvox
from morig_tpu_torch.nn.gcu import auto_select_edge_impl

import torch_port_fixtures as F

V_PAD = 128


@pytest.fixture(scope="module")
def capsules():
    """Two capsules of one vertex count (the second shifted and scaled), their
    32^3 grids and (V_PAD, V_PAD) surface geodesics, padded with 1e30."""
    out = []
    for shift, scale in ((0.0, 1.0), (0.05, 1.1)):
        rig = make_capsule_rig(7, 6)
        verts = (rig.verts * scale + shift).astype(np.float32)
        vox = tvox.voxelize_mesh(verts, rig.faces, dims=32)
        sg = np.full((V_PAD, V_PAD), 1e30, np.float32)
        n = len(verts)
        sg[:n, :n] = tgeo.surface_geodesic(verts, rig.faces, num_samples=500)
        out.append(dict(verts=verts, faces=rig.faces, vox=vox, sg=sg, rig=rig))
    return out


def _jax_triple(vox):
    return jvox.vox_to_device(jvox.Voxels(vox.data, vox.translate, vox.scale, vox.dims))


def test_voxelize_and_surface_geodesic_match_jax_package(capsules):
    for c in capsules:
        ref = jvox.voxelize_mesh(c["verts"], c["faces"], dims=32)
        np.testing.assert_array_equal(c["vox"].data, ref.data)
        np.testing.assert_array_equal(c["vox"].translate, ref.translate)
        assert c["vox"].scale == ref.scale and c["vox"].dims == ref.dims
        n = len(c["verts"])
        F.assert_close(c["sg"][:n, :n],
                       jgeo.surface_geodesic(c["verts"], c["faces"], num_samples=500),
                       atol=0, rtol=1e-6, what="surface geodesic")
    pts = np.random.default_rng(0).random((300, 3))
    np.testing.assert_array_equal(tgeo.fps_numpy(pts, 40, 3), jgeo.fps_numpy(pts, 40, 3))


def test_rcm_order_and_edge_dispatch():
    """RCM order and its application equal the JAX package's; a capsule
    with its vertices shuffled is not local at tile 16 and goes to K1,
    and after the RCM order it is local and goes to K5."""
    rig = make_capsule_rig(7, 6)
    n = len(rig.verts)
    perm = np.random.default_rng(1).permutation(n)
    inv = np.argsort(perm)
    verts, tpl, geo = rig.verts[perm], inv[rig.tpl_edges], inv[rig.geo_edges]
    order = tpre.rcm_vertex_order(n, tpl, geo)
    np.testing.assert_array_equal(order, jpre.rcm_vertex_order(n, tpl, geo))
    got = tpre.apply_vertex_order(order, verts, tpl, geo, np.arange(n))
    ref = jpre.apply_vertex_order(order, verts, tpl, geo, np.arange(n))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    shuffled = [build_mesh(verts, tpl, geo, 64, 12, 12)]
    ordered = [build_mesh(*got[:3], 64, 12, 12)]
    assert auto_select_edge_impl(shuffled, tile_v=16) == "fused"
    assert auto_select_edge_impl(ordered, tile_v=16) == "windowed"
    assert auto_select_edge_impl(ordered, tile_v=24) == "fused"    # 64 % 24 != 0
    assert auto_select_edge_impl(ordered, tile_v=32) == "fused"    # 2 tiles, not 3


def test_inside_check_and_fraction_exact(capsules):
    """Containment (round half to even, out-of-grid points outside) and the
    segment inside-fractions at 16 and 32 samples, bit for bit."""
    rng = np.random.default_rng(2)
    grid, tr, sc = tvox.vox_to_device([c["vox"] for c in capsules], "cpu")
    pts = np.stack([c["verts"][rng.integers(0, len(c["verts"]), 200)]
                    + rng.normal(0, 0.03, (200, 3)) for c in capsules]).astype(np.float32)
    # points on cell boundaries: ((p - t) / s) * dims lands on k + 0.5
    half = ((np.arange(6)[:, None] + 10.5) / 32.0).astype(np.float32)
    for b, c in enumerate(capsules):
        pts[b, :6] = (half * np.float32(c["vox"].scale)
                      + c["vox"].translate.astype(np.float32)).astype(np.float32)
    pts[:, 6] = 10.0                                            # outside the grid
    got = tvox.inside_check(torch.as_tensor(pts), grid, tr, sc).numpy()
    ends = np.roll(pts, 7, axis=1)
    for b, c in enumerate(capsules):
        jg = _jax_triple(c["vox"])
        np.testing.assert_array_equal(got[b], np.asarray(jvox.inside_check_jax(pts[b], *jg)))
        assert got[b].any() and not got[b].all()
    for n in (16, 32):
        np.testing.assert_array_equal(
            tvox.sample_params(n).numpy(), np.asarray(jnp.linspace(0.0, 1.0, n)))
        frac = tvox.segment_inside_fraction(torch.as_tensor(pts), torch.as_tensor(ends),
                                            grid, tr, sc, n).numpy()
        for b, c in enumerate(capsules):
            ref = jvox.segment_inside_fraction(pts[b], ends[b], *_jax_triple(c["vox"]), n)
            np.testing.assert_array_equal(frac[b], np.asarray(ref))


def _bones(rng, capsule, n_valid, M):
    """n_valid segments between points near the capsule's axis, padded to M."""
    lo, hi = capsule["verts"].min(0), capsule["verts"].max(0)
    mid = (lo + hi) / 2
    ends = mid + (rng.random((n_valid, 2, 3)) - 0.5) * (hi - lo) * [0.4, 1.0, 0.4]
    bones = np.zeros((M, 6), np.float32)
    bones[:n_valid] = ends.reshape(n_valid, 6)
    bones[3, 3:] = bones[3, :3]                                  # a zero-length leaf bone
    mask = np.arange(M) < n_valid
    return bones, mask


@pytest.mark.parametrize("M,n_valid", [(8, 6), (16, 13)])
def test_vertex_bone_geodesic_matches_jax(capsules, M, n_valid):
    """Bmax=8 runs the strided-anchor branch (every vertex casts to every
    bone), Bmax=16 the candidate branch (10 nearest bones per vertex), both
    with 32 anchors of 128 vertices and 16 line-of-sight samples."""
    rng = np.random.default_rng(M)
    verts = np.zeros((2, V_PAD, 3), np.float32)
    bones, masks = [], []
    for b, c in enumerate(capsules):
        verts[b, :len(c["verts"])] = c["verts"]
        verts[b, len(c["verts"]):] = c["verts"][0]               # padding rows
        bb, bm = _bones(rng, c, n_valid, M)
        bones.append(bb)
        masks.append(bm)
    bones, masks = np.stack(bones), np.stack(masks)
    sg = np.stack([c["sg"] for c in capsules])
    kw = dict(num_anchors=32, los_samples=16, num_candidates=10)
    got = tgeo.vertex_bone_geodesic_device(
        torch.as_tensor(verts), torch.as_tensor(bones), torch.as_tensor(masks),
        torch.as_tensor(sg).to(torch.bfloat16),
        *tvox.vox_to_device([c["vox"] for c in capsules], "cpu"), **kw).numpy()
    fn = jax.jit(lambda *a: jgeo.vertex_bone_geodesic_device(*a, **kw))
    for b, c in enumerate(capsules):
        ref = np.asarray(fn(verts[b], bones[b], masks[b], jnp.asarray(sg[b], jnp.bfloat16),
                            *_jax_triple(c["vox"])))
        assert (ref[:, ~masks[b]] == 1e30).all() and (got[b][:, ~masks[b]] == 1e30).all()
        F.assert_close(got[b], ref, atol=1e-5, rtol=1e-5, what=f"geodesic M={M} mesh {b}")
        # both kinds of pair occur: straight (visible) and detoured (occluded)
        straight = F.np_(point_to_segment_dist(torch.as_tensor(verts[b:b + 1]),
                                               torch.as_tensor(bones[b:b + 1]))[0][0])
        n = len(c["verts"])
        valid = np.zeros_like(ref, bool)
        valid[:n] = (ref[:n] < 1e29) & masks[b][None]
        assert (np.abs(ref - straight) < 1e-6)[valid].any()
        assert (ref > straight + 1e-3)[valid].any()
