"""morig_tpu_torch's file formats, dataset loaders and preprocessing against
morig_tpu's, on the same numpy inputs.

Writers (OBJ, PLY, .binvox, *_skel.txt) must produce the JAX package's
bytes, and each package must read the other's files; the loaders of the
reference layout (a folder as tests/test_loaders_roundtrip.py writes it)
must give every field equal; `preprocess_model` on a small capsule must
give equal edge tables and voxels, and geodesics within the host
vertex_bone_geodesic's tolerance (tests/test_torch_skel_train.py: 1e-6 +
1e-5 relative, fp32 point-to-segment distances summed in another order).
"""
from __future__ import annotations

import os

import numpy as np
import pytest
from torch_port_fixtures import assert_close

from morig_tpu import native as jnative
from morig_tpu.data import loaders as jload
from morig_tpu.data import mesh_io as jio
from morig_tpu.data import preprocess as jpre
from morig_tpu.data.synthetic import make_capsule_rig
from morig_tpu.geometry import skeleton as jsk
from morig_tpu.geometry import voxel as jvox
from morig_tpu_torch import native as tnative
from morig_tpu_torch.data import loaders as tload
from morig_tpu_torch.data import mesh_io as tio
from morig_tpu_torch.data import preprocess as tpre
from morig_tpu_torch.geometry import skeleton as tsk
from morig_tpu_torch.geometry import voxel as tvox


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _capsule_rigs(n_lat=9, n_lon=8):
    cap = make_capsule_rig(n_lat, n_lon)
    kw = dict(names=list(cap.names), pos=cap.joints.astype(float), parents=cap.parents,
              skins=cap.skins)
    return cap, jsk.Rig(**kw), tsk.Rig(**kw)


# ---------------------------------------------------------------------------
# writers and readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
def test_mesh_io_writers_equal_and_cross_read(tmp_path, binary):
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(37, 3)).astype(np.float32)
    faces = rng.integers(0, 37, (50, 3))
    paths = {}
    for name, io in (("jax", jio), ("torch", tio)):
        paths[name] = (str(tmp_path / f"{name}.obj"), str(tmp_path / f"{name}.ply"))
        io.write_obj(paths[name][0], verts, faces)
        io.write_ply_points(paths[name][1], verts, binary=binary)
    for k in range(2):
        assert _bytes(paths["jax"][k]) == _bytes(paths["torch"][k])
    for obj, ply in paths.values():                  # each reader on each writer's files
        for a, b in zip(tio.read_obj(obj), jio.read_obj(obj), strict=True):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tio.read_ply_points(ply), jio.read_ply_points(ply))
    if binary:                                       # ascii keeps 6 decimals
        np.testing.assert_array_equal(tio.read_ply_points(paths["jax"][1]), verts)


def test_obj_polygons_and_edge_files(tmp_path):
    """Fan triangulation of polygon faces with `v/vt` indices, and edge
    lists of one row or many."""
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nf 1/1 2/2 3/3 4/4\nf 1 2 5\n")
    for a, b in zip(tio.read_obj(str(obj)), jio.read_obj(str(obj))):
        np.testing.assert_array_equal(a, b)
    for rows in ([[0, 1]], [[0, 1], [1, 2], [2, 3]]):
        p = str(tmp_path / f"e{len(rows)}.txt")
        np.savetxt(p, np.asarray(rows), fmt="%d")
        got, ref = tio.load_edge_file(p), jio.load_edge_file(p)
        assert got.dtype == ref.dtype == np.int64
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dims", [16, 88])
def test_binvox_round_trips_through_both_writers(tmp_path, dims):
    """The port's voxel grid of a capsule, written by both packages' writers:
    the same bytes, and each reader gives the grid, translate and scale
    back."""
    cap, _, _ = _capsule_rigs()
    vox = tvox.voxelize_mesh(cap.verts, cap.faces, dims=dims)
    pt, pj = str(tmp_path / "t.binvox"), str(tmp_path / "j.binvox")
    tvox.write_binvox(vox, pt)
    jvox.write_binvox(jvox.Voxels(vox.data, vox.translate, vox.scale, vox.dims), pj)
    assert _bytes(pt) == _bytes(pj)
    for path in (pt, pj):
        for got in (tvox.read_binvox(path), jvox.read_binvox(path)):
            np.testing.assert_array_equal(got.data, vox.data)
            assert got.dims == dims
            np.testing.assert_allclose(got.translate, vox.translate, rtol=1e-5)
            np.testing.assert_allclose(got.scale, vox.scale, rtol=1e-5)


def test_binvox_runs_longer_than_255(tmp_path):
    data = np.zeros((12, 12, 12), bool)
    data[:7] = True                          # a run of 1008 ones, then 720 zeros
    vox = tvox.Voxels(data, np.zeros(3), 1.0, 12)
    tvox.write_binvox(vox, str(tmp_path / "t.binvox"))
    jvox.write_binvox(jvox.Voxels(data, np.zeros(3), 1.0, 12), str(tmp_path / "j.binvox"))
    assert _bytes(tmp_path / "t.binvox") == _bytes(tmp_path / "j.binvox")
    np.testing.assert_array_equal(tvox.read_binvox(str(tmp_path / "j.binvox")).data, data)


def test_skel_format_and_bone_helpers(tmp_path):
    """save_skel_format bytes, both readers on both files, map_bones and
    prim_mst_middle_first equal to the JAX package's."""
    _, jrig, trig = _capsule_rigs()
    jsk.save_skel_format(jrig, str(tmp_path / "j_skel.txt"))
    tsk.save_skel_format(trig, str(tmp_path / "t_skel.txt"))
    assert _bytes(tmp_path / "j_skel.txt") == _bytes(tmp_path / "t_skel.txt")
    for path in ("j_skel.txt", "t_skel.txt"):
        got, ref = tsk.load_skel_format(str(tmp_path / path)), jsk.load_skel_format(
            str(tmp_path / path))
        assert isinstance(got, tsk.Rig) and got.names == ref.names
        np.testing.assert_array_equal(got.pos, ref.pos)
        np.testing.assert_array_equal(got.parents, ref.parents)
    rng = np.random.default_rng(1)
    old, new = rng.normal(size=(9, 6)), rng.normal(size=(14, 6))
    np.testing.assert_array_equal(tsk.map_bones(old, new), jsk.map_bones(old, new))
    for seed in range(4):
        r = np.random.default_rng(seed)
        joints = r.normal(scale=0.3, size=(11, 3))
        joints[:3, 0] = 0.0                              # middle joints
        joints[3:7] = joints[7:11] * [-1, 1, 1]          # mirrored pairs
        cost = np.linalg.norm(joints[:, None] - joints[None], axis=-1) + r.uniform(size=(11, 11))
        cost = 0.5 * (cost + cost.T)
        got, ref = tsk.prim_mst_middle_first(cost, 5, joints), jsk.prim_mst_middle_first(
            cost, 5, joints)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]


def test_rig_fk_matches_jax():
    _, jrig, trig = _capsule_rigs()
    rng = np.random.default_rng(2)
    q = rng.normal(size=(trig.num_joints, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    import jax.numpy as jnp
    from morig_tpu.geometry.rotations import quaternion_to_matrix

    R = np.asarray(quaternion_to_matrix(jnp.asarray(q)), np.float64)
    for got, ref in zip(trig.fk(R, np.array([0.1, 0.2, 0.3])),
                        jrig.fk(R, np.array([0.1, 0.2, 0.3]))):
        np.testing.assert_array_equal(got, ref)


def test_rig_global_transforms_homogeneous_match_jax():
    """The (J,4,4) global transforms, at the rest pose and at random local
    rotations with a root translation, equal the JAX package's bit for bit."""
    _, jrig, trig = _capsule_rigs()
    rng = np.random.default_rng(3)
    R = np.linalg.qr(rng.normal(size=(trig.num_joints, 3, 3)))[0]
    rest = trig.global_transforms_homogeneous()
    np.testing.assert_array_equal(rest, jrig.global_transforms_homogeneous())
    assert rest.shape == (trig.num_joints, 4, 4) and (rest[:, 3] == [0, 0, 0, 1]).all()
    np.testing.assert_array_equal(trig.global_transforms_homogeneous(R, np.array([0.1, 0.2, 0.3])),
                                  jrig.global_transforms_homogeneous(R, np.array([0.1, 0.2, 0.3])))


# ---------------------------------------------------------------------------
# the reference-layout loaders
# ---------------------------------------------------------------------------

def _write_pose_folder(folder, name, num_frames, corr_frames, seed=3):
    """One model in the layout tests/test_loaders_roundtrip.py writes."""
    rng = np.random.default_rng(seed)
    V, P = 20, 16
    n = len(corr_frames)
    pre = os.path.join(folder, name)
    np.save(pre + "_vtx_traj.npy", rng.normal(size=(V, num_frames * 3)).astype(np.float32))
    np.save(pre + "_pts_traj.npy", rng.normal(size=(P, num_frames * 3)).astype(np.float32))
    np.save(pre + "_vismask.npy", rng.uniform(size=(V, num_frames)).astype(np.float32))
    np.save(pre + "_corr_v2p.npy", np.stack([rng.integers(0, V, n), rng.integers(0, P, n),
                                             np.asarray(corr_frames)], 1).astype(np.int64))
    np.save(pre + "_corr_p2v.npy", np.stack([rng.integers(0, P, n), rng.integers(0, V, n),
                                             np.asarray(corr_frames)], 1).astype(np.int64))
    np.savetxt(pre + "_tpl_e.txt", np.array([[0, 1], [1, 2], [2, 3]]), fmt="%d")
    np.savetxt(pre + "_geo_e.txt", np.array([[0, 2], [1, 3]]), fmt="%d")
    return pre


def _assert_models_equal(got, ref, fields):
    assert got.name == ref.name
    for f in fields:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)


POSE_FIELDS = ("vtx_traj", "pts_traj", "corr_v2p", "corr_p2v", "vismask", "tpl_edges",
               "geo_edges")


@pytest.mark.parametrize("kind,sequential,num_frames,corr_frames", [
    ("modelsresource", False, 101, [0, 5, 20, 37, 40, 60, 80, 99, 100]),
    ("deformingthings", False, 100, [0, 19, 20, 38, 57, 76, 95, 99]),
    ("modelsresource", True, 101, [0, 1, 7, 20, 21, 50]),
])
def test_load_pose_models_equal(tmp_path, kind, sequential, num_frames, corr_frames):
    for i, name in enumerate(("b", "a")):
        _write_pose_folder(str(tmp_path), name, num_frames, corr_frames, seed=3 + i)
    got = tload.load_pose_models(str(tmp_path), kind, sequential)
    ref = jload.load_pose_models(str(tmp_path), kind, sequential)
    assert [m.name for m in got] == ["a", "b"]
    for g, r in zip(got, ref, strict=True):
        _assert_models_equal(g, r, POSE_FIELDS)
    assert len(tload.load_pose_models(str(tmp_path), kind, sequential, limit=1)) == 1


def _tiny_rig(V=12):
    skins = np.zeros((V, 3))
    skins[:4, 0] = skins[4:8, 1] = skins[8:, 2] = 1.0
    return dict(names=["root", "mid", "tip"],
                pos=np.array([[0.0, 0.0, 0.0], [0.0, 0.3, 0.0], [0.0, 0.6, 0.0]]),
                parents=np.array([-1, 0, 1]), skins=skins)


def _write_skin_file(path, rig, K=20, seed=5):
    """The reference's gen_skin_data.py writer format (as
    tests/test_loaders_roundtrip.py), with missing slots (-1)."""
    bones, bone_names, isleaf = jsk.get_bones(rig)
    rng = np.random.default_rng(seed)
    V = rig.skins.shape[0]
    with open(path, "w") as f:
        for i, (pn, cn) in enumerate(bone_names):
            f.write(f"bones {pn} {cn} " + " ".join(f"{x:.6f}" for x in bones[i]) + "\n")
        for vid in range(V):
            order = rng.permutation(len(bones))
            slots = [f"{int(order[i])} {1.0 / (0.1 + i):.6f} {int(isleaf[order[i]])}"
                     if i < len(order) else "-1 0.0 0" for i in range(K)]
            f.write(f"bind {vid} " + " ".join(slots) + "\n")
        for vid in range(V):
            f.write("influence " + " ".join(f"{x:.3f}" for x in rng.uniform(size=K)) + "\n")


RIG_FIELDS = ("verts", "tpl_edges", "geo_edges", "gt_flow", "pred_flow", "attn", "skin_input",
              "skin_label", "skin_nn", "loss_mask")


@pytest.mark.parametrize("with_skin,with_pred_flow", [(True, True), (False, False)])
def test_load_rig_models_and_skin_file_equal(tmp_path, with_skin, with_pred_flow):
    """`load_rig_models` (rig, attention, optional skin file and pred_flow
    dumps; keyframes 20..100) and `parse_skin_file` give every field the
    JAX loaders give."""
    rig = jsk.Rig(**_tiny_rig())
    V, T = 12, 101
    rng = np.random.default_rng(11)
    folder = str(tmp_path)
    for name in ("7", "3"):
        pre = os.path.join(folder, name)
        np.save(pre + "_vtx_traj.npy", rng.normal(size=(V, T, 3)).astype(np.float32))
        np.savetxt(pre + "_tpl_e.txt", np.array([[0, 1], [1, 2]]), fmt="%d")
        np.savetxt(pre + "_geo_e.txt", np.array([[0, 2]]), fmt="%d")
        rig.save(pre + "_rig.txt")
        np.savetxt(pre + "_attn.txt", (rng.uniform(size=V) > 0.5).astype(np.float32))
        if with_skin:
            _write_skin_file(pre + "_skin.txt", rig)
        if with_pred_flow:
            os.makedirs(os.path.join(folder, "pred_flow"), exist_ok=True)
            for t in range(1, 6):
                np.save(os.path.join(folder, "pred_flow", f"{name}_{t}_pred_flow.npy"),
                        rng.normal(size=(V, 3)).astype(np.float32))
    got, ref = tload.load_rig_models(folder), jload.load_rig_models(folder)
    assert [m.name for m in got] == ["3", "7"]
    for g, r in zip(got, ref, strict=True):
        _assert_models_equal(g, r, RIG_FIELDS)
        assert isinstance(g.rig, tsk.Rig) and g.rig.names == r.rig.names
        for f in ("pos", "parents", "skins"):
            np.testing.assert_array_equal(getattr(g.rig, f), getattr(r.rig, f))
    if with_skin:
        path = os.path.join(folder, "7_skin.txt")
        for a, b in zip(tload.parse_skin_file(path), jload.parse_skin_file(path), strict=True):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_load_shape_models_equal(tmp_path):
    rng = np.random.default_rng(4)
    V, P = 10, 8
    for name, corr_cols in (("s1", 2), ("s2", 3)):
        pre = str(tmp_path / name)
        jio.write_obj(pre + "_0.obj", rng.normal(size=(V, 3)), rng.integers(0, V, (6, 3)))
        np.save(pre + "_pts.npy", rng.normal(size=(P, 3)))
        np.save(pre + "_flow.npy", rng.normal(size=(V, 3)))
        for key, n in (("v2p", V), ("p2v", P)):
            np.save(f"{pre}_corr_{key}.npy", rng.integers(0, min(V, P), (n, corr_cols)))
        np.save(pre + "_vismask.npy", rng.uniform(size=(V, 1)))
        np.savetxt(pre + "_tpl_e.txt", np.array([[0, 1], [1, 2]]), fmt="%d")
        np.savetxt(pre + "_geo_e.txt", np.array([[0, 2]]), fmt="%d")
    got, ref = tload.load_shape_models(str(tmp_path)), jload.load_shape_models(str(tmp_path))
    assert len(got) == 2
    for g, r in zip(got, ref, strict=True):
        _assert_models_equal(g, r, POSE_FIELDS)


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def test_native_one_ring_and_voxel_bfs_equal():
    cap, _, _ = _capsule_rigs()
    np.testing.assert_array_equal(tnative.one_ring_edges(cap.faces),
                                  jnative.one_ring_edges(cap.faces))
    vox = tvox.voxelize_mesh(cap.verts, cap.faces, dims=24)
    seeds = np.array([[12, 3, 12], [12, 20, 12], [-1, 0, 0]], np.int32)   # one outside
    got, ref = tnative.voxel_bfs(vox.data, seeds), jnative.voxel_bfs(vox.data, seeds)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_preprocess_helpers_equal():
    cap, jrig, trig = _capsule_rigs(13, 12)
    np.testing.assert_array_equal(tpre.get_tpl_edges(cap.faces), jpre.get_tpl_edges(cap.faces))
    rng = np.random.default_rng(6)
    g = rng.uniform(0, 0.2, (60, 60))
    g = 0.5 * (g + g.T)
    for radius, max_nn in ((0.06, 15), (0.15, 4)):
        np.testing.assert_array_equal(tpre.get_geo_edges(g, radius, max_nn, seed=2),
                                      jpre.get_geo_edges(g, radius, max_nn, seed=2))
    assert tpre.get_geo_edges(g + 1.0).shape == (0, 2)
    for a, b in zip(tpre.normalize_mesh(cap.verts), jpre.normalize_mesh(cap.verts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpre.gt_attention_mask(cap.verts, trig),
                                  jpre.gt_attention_mask(cap.verts, jrig))
    vox = tvox.voxelize_mesh(cap.verts, cap.faces, dims=48)
    bones, _, _ = tsk.get_bones(trig)
    np.testing.assert_array_equal(
        tpre.volumetric_geodesic_bfs(cap.verts, vox, bones),
        jpre.volumetric_geodesic_bfs(cap.verts, jvox.Voxels(vox.data, vox.translate, vox.scale,
                                                            vox.dims), bones))


def test_preprocess_model_matches_jax_and_caches(tmp_path):
    """preprocess_model on a capsule (V=66, 32^3 voxels) with its rig: edge
    tables, attention and bones equal to the JAX package's, the voxel files
    byte for byte, surface geodesics within 1e-6 relative and the
    volumetric geodesic within 1e-6 + 1e-5 relative; a second call reads
    every array back from its cache."""
    cap, jrig, trig = _capsule_rigs()
    kw = dict(name="cap", vox_dims=32)
    got = tpre.preprocess_model(cap.verts, cap.faces, trig, cache_dir=str(tmp_path / "t"),
                                device="cpu", **kw)
    ref = jpre.preprocess_model(cap.verts, cap.faces, jrig, cache_dir=str(tmp_path / "j"), **kw)
    for k in ("tpl_edges", "geo_edges", "attn", "bones", "bone_isleaf"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the two packages build the C++ Dijkstra with other compiler flags
    # (fused multiply-adds): fp32 path sums differ in the last bit, as in
    # test_torch_geometry
    assert_close(got["surface_geodesic"], ref["surface_geodesic"], atol=0, rtol=1e-6,
                 what="surface geodesic")
    assert got["bone_names"] == ref["bone_names"]
    np.testing.assert_array_equal(got["vox"].data, ref["vox"].data)
    assert_close(got["vertex_bone_geodesic"], ref["vertex_bone_geodesic"], atol=1e-6, rtol=1e-5,
                 what="vertex_bone_geodesic")
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "cap.binvox", "cap_geo.npz", "cap_sgeo.npz", "cap_tpl.npz", "cap_vbgeo.npz"]
    assert _bytes(tmp_path / "t" / "cap.binvox") == _bytes(tmp_path / "j" / "cap.binvox")
    again = tpre.preprocess_model(cap.verts[::-1].copy(), cap.faces, trig,   # other input:
                                  cache_dir=str(tmp_path / "t"), device="cpu", **kw)  # cache wins
    for k in ("tpl_edges", "geo_edges", "surface_geodesic", "vertex_bone_geodesic"):
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)
    np.testing.assert_array_equal(again["vox"].data, got["vox"].data)
