"""The last public pieces of the JAX package's surface in the port, against
the JAX package on the CPU: the inference precision switch
(`set_inference_dtype`), the config groups `PointBranchConfig` and
`MeshBucketConfig`, the host helpers `vertex_normals`,
`ik_objective_weights`, `knn_interpolate`, `masked_mean` and
`extract_joints_batch`, and `SAModuleMSG` with its flax weights carried
across by `weights.flax_to_state_dict`.  Inputs come from numpy seeds and go
to both sides; each tolerance is stated with its reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.core import config as jcfg
from morig_tpu.geometry import clustering as jcl
from morig_tpu.geometry import geodesic as jgeo
from morig_tpu.geometry import ik as jik
from morig_tpu.kernels import neighbors as jnb
from morig_tpu.nn import gcu as jgcu
from morig_tpu.nn import mlp as jmlp
from morig_tpu.nn import pointnet as jpn
from morig_tpu_torch import weights as W
from morig_tpu_torch.core import config as tcfg
from morig_tpu_torch.data.synthetic import make_capsule_rig
from morig_tpu_torch.geometry import clustering as tcl
from morig_tpu_torch.geometry import geodesic as tgeo
from morig_tpu_torch.geometry import ik as tik
from morig_tpu_torch.kernels import neighbors as tnb
from morig_tpu_torch.nn import gcu as tgcu
from morig_tpu_torch.nn import mlp as tmlp
from morig_tpu_torch.nn import pointnet as tpn

import torch_port_fixtures as F
from torch_port_fixtures import TIGHT, assert_close

t = torch.as_tensor


@pytest.fixture
def inference_dtype():
    """Both packages' inference dtype, restored after the test."""
    prev = jmlp._INFER_DTYPE, tmlp.get_inference_dtype()
    yield
    jmlp.set_inference_dtype(prev[0])
    tmlp.set_inference_dtype(prev[1])


# ---------------------------------------------------------------------------
# set_inference_dtype
# ---------------------------------------------------------------------------

JAX_DTYPES = {None: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("name", ["auto", "bf16", "f32"])
def test_inference_dtype_follows_jax(name, inference_dtype):
    """The matmul dtype of the "layer"-mode MLPs in each setting, as the JAX
    package's `infer_matmul_dtype` on the CPU: at inference "auto" and "f32"
    fp32, "bf16" bf16; in training fp32 whatever the setting.  On a CUDA
    tensor "auto" is bf16 (the JAX package's accelerator rule)."""
    jmlp.set_inference_dtype(name)
    tmlp.set_inference_dtype(name)
    x = torch.zeros(2, 3)
    for train in (False, True):
        assert tmlp.matmul_dtype(x, train) == JAX_DTYPES[jmlp.infer_matmul_dtype(train)]
    cuda_like = torch.empty(0, device="meta")
    expected = {"auto": torch.float32, "bf16": torch.bfloat16, "f32": torch.float32}[name]
    assert tmlp.matmul_dtype(cuda_like) == expected      # a meta tensor is not a CUDA one
    with pytest.raises(ValueError):
        tmlp.set_inference_dtype("fp16")


@pytest.mark.parametrize("name", ["auto", "bf16", "f32"])
def test_inference_dtype_network_matches_flax(name, inference_dtype):
    """A GCU (two edge layers, fuse MLP) and an MLPHead at inference from the
    same weights in each setting.  The edge messages stay bf16 in every
    setting on both sides (the JAX `edge_dtype`); the MLPs compute in the
    setting's dtype.  fp32 MLPs ("auto" and "f32" on the CPU) agree to the
    edge layers' bf16 noise (LAYER, torch_port_fixtures); "bf16" MLPs round
    inputs and weights to bf16 on both sides, from fp32 values computed in
    another order, so one bf16 ulp (2^-8) of an O(1) activation: 2e-2 of
    the mean, 1e-1 of the max magnitude."""
    jmlp.set_inference_dtype(name)
    tmlp.set_inference_dtype(name)
    entries, _ = F.capsule_inputs(2)
    jm, tm = F.meshes(entries)
    vm = np.asarray(jm.vert_mask)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, F.V_PAD, 32)).astype(np.float32)
    tol = (2e-2, 1e-1) if name == "bf16" else F.LAYER
    jgcu_m = jgcu.GCU(64)
    p = F.flax_params(jgcu_m, 11, jnp.asarray(x), jm)
    with F.jax_fused_kernels():
        ref = jgcu_m.apply({"params": p}, jnp.asarray(x), jm)
    net = F.bridged(lambda: tgcu.GCU(32, 64), W.flax_to_state_dict(p))
    F.assert_rel_close(net(t(x), tm), ref, tol, vm, f"GCU {name}")
    head = jmlp.MLPHead([64, 32], 8)
    ph = F.flax_params(head, 12, jnp.asarray(x))
    href = head.apply({"params": ph}, jnp.asarray(x))
    hnet = F.bridged(lambda: tmlp.MLPHead(32, [64, 32], 8), W.flax_to_state_dict(ph))
    got = hnet(t(x))
    assert got.dtype == torch.float32
    F.assert_rel_close(got, href, tol, vm, f"MLPHead {name}")


# ---------------------------------------------------------------------------
# config groups and host helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["points", "buckets"])
def test_point_branch_and_bucket_configs_match_jax(group):
    """PointBranchConfig and MeshBucketConfig: the same fields and defaults,
    and the port's Config carries them under the JAX names."""
    port, ref = getattr(tcfg.DEFAULT_CONFIG, group), getattr(jcfg.DEFAULT_CONFIG, group)
    assert type(port).__name__ == type(ref).__name__
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert [f.name for f in dataclasses.fields(tcfg.Config)] == [
        f.name for f in dataclasses.fields(jcfg.Config)]


def test_vertex_normals_match_jax():
    """Area-weighted vertex normals of the capsule, numpy on both sides:
    bit for bit."""
    cap = make_capsule_rig(9, 8)
    got = tgeo.vertex_normals(cap.verts, cap.faces)
    np.testing.assert_array_equal(got, jgeo.vertex_normals(cap.verts, cap.faces))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_ik_objective_weights_match_jax():
    """1 where visible, w_invis elsewhere, exactly; the threshold strict."""
    vis = np.array([[0.0, 0.3, 0.31, 1.0], [0.5, 0.29, 0.3, 0.9]], np.float32)
    got = tik.ik_objective_weights(t(vis), 0.3, 0.25)
    ref = np.asarray(jik.ik_objective_weights(jnp.asarray(vis), 0.3, 0.25))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k", [1, 3])
def test_knn_interpolate_and_masked_mean_match_jax(k):
    """The batched forms against the JAX per-sample functions (vmapped), with
    masked sources: the interpolation at 1e-5 relative (fp32 weights summed
    in another order), the masked mean (an all-masked row gives 0) at 1e-6."""
    rng = np.random.default_rng(k)
    src = rng.random((2, 60, 3)).astype(np.float32)
    tar = rng.random((2, 40, 3)).astype(np.float32)
    x = rng.standard_normal((2, 60, 5)).astype(np.float32)
    smask = rng.random((2, 60)) < 0.8
    got = tnb.knn_interpolate(t(x), t(src), t(tar), k=k, src_mask=t(smask))
    ref = jax.vmap(lambda xx, s, tt, m: jnb.knn_interpolate(xx, s, tt, k=k, src_mask=m))(
        x, src, tar, smask)
    assert_close(got, ref, atol=1e-5, rtol=1e-5, what="knn_interpolate")
    mask = rng.random((2, 60)) < 0.5
    mask[1] = False
    for dim, m in ((1, mask), (2, np.ones((2, 60, 5), bool))):
        assert_close(tnb.masked_mean(t(x), t(m), dim), jnb.masked_mean(x, m, axis=dim),
                     atol=1e-6, rtol=1e-6, what=f"masked_mean {dim}")


@pytest.mark.parametrize("case", ["plain", "inside", "no_symmetry"])
def test_extract_joints_batch_matches_jax(case):
    """The padded batch variant of joint extraction (three meshes of shifted
    points, one with a padded tail and one with every point filtered out):
    host filters and reflection, bandwidth, mean-shift and counts on the
    device (here the CPU), host NMS and flip.  fp32 on both sides, the JAX
    bandwidth by its default bisection: the same joint count per mesh,
    joints within TIGHT."""
    rng = np.random.default_rng(len(case))
    B, V = 3, 200
    centres = rng.uniform([-0.1, -0.05, -0.1], [0.1, 0.6, 0.1], (B, 6, 3))
    pts = np.stack([c[rng.integers(0, 6, V)] for c in centres])
    pts = (pts + 0.02 * rng.standard_normal((B, V, 3))).astype(np.float32)
    attn = rng.random((B, V)).astype(np.float32)
    valid = np.ones((B, V), bool)
    valid[1, 150:] = False
    valid[2] = False
    inside = [lambda p: p[:, 1] < 0.4, None, None] if case == "inside" else None
    kw = dict(symmetrize=case != "no_symmetry")
    got = tcl.extract_joints_batch(pts, attn, valid, inside, device="cpu", **kw)
    ref = jcl.extract_joints_batch(pts, attn, valid, inside, **kw)
    assert len(got) == len(ref) == B and len(got[2]) == 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert_close(g, r, atol=TIGHT, what="joints")
    assert len(got[0]) >= 2


# ---------------------------------------------------------------------------
# SAModuleMSG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_x", [True, False])
def test_sa_module_msg_matches_flax(with_x):
    """A two-scale SAModuleMSG (radii 0.1 and 0.25, 16 and 32 neighbours,
    MLPs [16, 32] and [32, 64]) at inference from the flax module's seeded
    weights, loaded by `flax_to_state_dict` (`conv_0`, `conv_1`) with
    strict=True: the same centroids and their mask exactly, the
    concatenated features within TIGHT (fp32 MLPs on the CPU on both sides,
    exact radius grouping: the JAX top-k mode "exact").  The gathers run K3's
    plain version."""
    rng = np.random.default_rng(int(with_x))
    pos = rng.random((2, 128, 3)).astype(np.float32) * 0.5
    mask = rng.random((2, 128)) < 0.9
    x = rng.standard_normal((2, 128, 4)).astype(np.float32) if with_x else None
    fin = 4 if with_x else 0
    jm = jpn.SAModuleMSG(32, (0.1, 0.25), ((16, 32), (32, 64)), (16, 32))
    args = (None if x is None else jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mask))
    p = F.flax_params(jm, 5, *args)
    jnb.set_topk_mode("exact")
    try:
        ref, ref_pos, ref_mask = jm.apply({"params": p}, *args)
    finally:
        jnb.set_topk_mode("auto")
    net = F.bridged(lambda: tpn.SAModuleMSG(fin, (0.1, 0.25), ((16, 32), (32, 64)), (16, 32)),
                    W.flax_to_state_dict(p))
    assert {n.split(".")[0] for n, _ in net.named_parameters()} == {"conv_0", "conv_1"}
    got, got_pos, got_mask = net(None if x is None else t(x), t(pos), t(mask), 32)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(ref_pos))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    assert got.shape == (2, 32, 96)
    assert_close(got, ref, atol=TIGHT, rtol=TIGHT, what="features")
