"""The loader of the reference's PyTorch state dicts (morig_tpu_torch.eval.
torch_import) against the JAX package's (morig_tpu.eval.torch_import).

For each of the seven networks a module with the reference's state-dict
key layout (the oracles of tests/torch_oracle.py and the skeletons of
tests/test_parity_torch.py; the rigging networks at width_scale 0.25) is
filled from a seed, BatchNorm statistics included.  The port's loader must
give, key for key and bit for bit, what the JAX importer composed with
`weights.flax_to_state_dict` gives, and load strictly into the port's
network built in "batch" norm mode.  Then that network in inference
against the flax network on the JAX importer's variables, on the same
inputs, fp32 on both sides, within EVAL (1e-4 absolute and relative); and
against the oracle where tests/torch_oracle.py has the module (CorrNet's
mesh encoder, GCNDeform, the rigging networks), on the unpadded mesh.

The JAX side runs its kNN and row gather through the Pallas kernels in
interpret mode (bf16 similarity, as the port's K2) and its radius grouping
with an exact top-k.  DeformNet's voting and completion select by K2 and a
0.5 visibility threshold, where an fp32-level difference can flip a
choice, so its flow is held given the flax CorrNet outputs, as in
tests/test_torch_modules.py; CorrNet is held whole.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morig_tpu.core import batch as JB
from morig_tpu.eval import torch_import as jti
from morig_tpu.kernels import neighbors as jnb
from morig_tpu.nn import bonenet as jbn
from morig_tpu.nn import corrnet as jcn
from morig_tpu.nn import deformnet as jdn
from morig_tpu.nn import rignet as jrn
from morig_tpu_torch import weights as W
from morig_tpu_torch.core import batch as TB
from morig_tpu_torch.eval import torch_import as tti
from morig_tpu_torch.nn import bonenet as tbn
from morig_tpu_torch.nn import corrnet as tcn
from morig_tpu_torch.nn import deformnet as tdn
from morig_tpu_torch.nn import rignet as trn

import torch_port_fixtures as F
from test_parity_torch import (_BoneNetSkeleton, _capsule_graph, _CorrNetSkeleton,
                               _RootNetSkeleton)
from torch_oracle import (GCNDeformOracle, GCNRigOracle, MeshEncoderOracle, SkinNetInnerOracle,
                          TemporalAttnOracle, randomize_bn_stats)

EVAL = 1e-4
SCALE = 0.25            # width_scale of the rigging networks
T, K = 2, 5             # keyframes, nearest bones


def _w(c: int) -> int:
    return max(8, int(c * SCALE))


class RigOracle(torch.nn.Module):
    """The reference JointNetMotion / MaskNetMotion (attention aggregation)
    at width_scale SCALE: motionNet, `aggragator` [sic] and the head."""

    def __init__(self, head: str, chn_output: int):
        super().__init__()
        self.head = head
        self.motionNet = GCNRigOracle(3, 32, SCALE)
        self.aggragator = TemporalAttnOracle(32, 2, _w(64), _w(512), 64)
        setattr(self, head, GCNRigOracle(64, chn_output, SCALE))

    def motion(self, pos, flow, tpl, geo):
        feats = [torch.nn.functional.normalize(
            self.motionNet(pos, flow[:, 3 * t:3 * t + 3], tpl, geo), dim=1) for t in range(T)]
        return torch.nn.functional.normalize(self.aggragator(torch.stack(feats, 1)), dim=1)

    def forward(self, pos, flow, tpl, geo):
        return getattr(self, self.head)(pos, self.motion(pos, flow, tpl, geo), tpl, geo)


class SkinOracle(RigOracle):
    """The reference SkinMotion at width_scale SCALE."""

    def __init__(self):
        torch.nn.Module.__init__(self)
        self.motionNet = GCNRigOracle(3, 32, SCALE)
        self.aggragator = TemporalAttnOracle(32, 2, _w(64), _w(512), 32)
        self.skinNet = SkinNetInnerOracle(K, 32, SCALE)

    def forward(self, pos, skin_input, flow, tpl, geo):
        return self.skinNet(pos, skin_input, self.motion(pos, flow, tpl, geo), tpl, geo)


class DeformSkeleton(torch.nn.Module):
    """The reference DeformNet's key layout: a CorrNet `corr_extractor` and
    the GCNDeform `completing` (its head misspelt `mlp_tramsform`)."""

    def __init__(self):
        super().__init__()
        self.corr_extractor = _CorrNetSkeleton()
        self.completing = GCNDeformOracle(4, 3)


# name: (reference module, JAX importer, flax network, port network)
NETS = {
    "corr": (_CorrNetSkeleton, jti.import_corrnet, lambda: jcn.CorrNet(num_points=128),
             tcn.CorrNet),
    "deform": (DeformSkeleton, jti.import_deformnet, jdn.DeformNet, tdn.DeformNet),
    "joint": (lambda: RigOracle("jointnet", 3), jti.import_jointnet,
              lambda: jrn.JointNetMotion(T, width_scale=SCALE),
              lambda: trn.JointNetMotion(T, width_scale=SCALE)),
    "mask": (lambda: RigOracle("masknet", 1), jti.import_masknet,
             lambda: jrn.MaskNetMotion(T, width_scale=SCALE),
             lambda: trn.MaskNetMotion(T, width_scale=SCALE)),
    "skin": (SkinOracle, jti.import_skinmotion,
             lambda: jrn.SkinMotion(K, num_keyframes=T, width_scale=SCALE),
             lambda: trn.SkinMotion(K, num_keyframes=T, width_scale=SCALE)),
    "bone": (_BoneNetSkeleton, jti.import_bonenet, jbn.BoneNet, tbn.BoneNet),
    "root": (_RootNetSkeleton, jti.import_rootnet, jbn.RootNet, tbn.RootNet),
}


def reference(name: str, seed: int) -> torch.nn.Module:
    """The reference-layout module of `name`, filled from `seed`: Linear
    weights by torch's default initialization, BatchNorm affine parameters
    and running statistics by `randomize_bn_stats`."""
    torch.manual_seed(seed)
    ref = NETS[name][0]()
    randomize_bn_stats(ref, torch.Generator().manual_seed(seed))
    return ref.eval()


@pytest.fixture(scope="module")
def batch_mode():
    with F.norm_mode("batch"):
        yield


@pytest.fixture(scope="module")
def inputs():
    """The capsule (38 vertices) padded to 128 with lossless degree-24
    tables, as one entry; 128 points; keyframe flows; skin descriptors;
    8 joint slots (6 valid) with their 28 pairs."""
    verts, tpl, geo = _capsule_graph(n_lat=7, n_lon=6)
    entry = JB.build_mesh(verts, tpl, geo, pad_verts=128, tpl_max_degree=24, geo_max_degree=24)
    for table in ("tpl_mask", "geo_mask"):          # lossless: every edge kept
        assert entry[table].sum(1).max() < 24
    rng = np.random.default_rng(0)
    V = len(verts)
    pts = (0.6 * rng.standard_normal((1, 128, 3))).astype(np.float32)
    flow = np.zeros((1, 128, 3 * T), np.float32)
    flow[0, :V] = 0.1 * rng.standard_normal((V, 3 * T))
    skin = np.zeros((1, 128, 8 * K), np.float32)
    skin[0, :V] = rng.standard_normal((V, 8 * K))
    J = 8
    joints = (0.3 * rng.standard_normal((1, J, 3))).astype(np.float32)
    jmask = np.arange(J)[None] < 6
    pairs = np.asarray(list(itertools.combinations(range(J), 2)), np.int64)[None]
    attr = rng.random((1, len(pairs[0]), 2)).astype(np.float32)
    return dict(verts=verts, tpl=tpl, geo=geo, V=V, jm=JB.stack_meshes([entry]),
                tm=TB.stack_meshes([entry], device="cpu"), pts=pts, flow=flow, skin=skin,
                joints=joints, jmask=jmask, pairs=pairs, attr=attr)


def _args(name, d, jax_side: bool):
    """The network's inference arguments on one side."""
    if jax_side:
        t = jnp.asarray
        mesh, pts = d["jm"], JB.PointBatch(t(d["pts"]), jnp.ones((1, 128), bool))
    else:
        t = torch.as_tensor
        mesh, pts = d["tm"], TB.PointBatch(t(d["pts"]), torch.ones((1, 128), dtype=torch.bool))
    return {"corr": (mesh, pts), "deform": (mesh, pts), "joint": (t(d["flow"]), mesh),
            "mask": (t(d["flow"]), mesh), "skin": (t(d["skin"]), t(d["flow"]), mesh),
            "bone": (mesh, t(d["joints"]), t(d["jmask"]), t(d["pairs"]), t(d["attr"])),
            "root": (mesh, t(d["joints"]), t(d["jmask"]))}[name]


@pytest.fixture(scope="module")
def imported(batch_mode):
    """For each network: its reference module, the JAX importer's
    (params, batch_stats) and the port loader's state dict."""
    out = {}
    for seed, name in enumerate(NETS):
        ref = reference(name, 40 + seed)
        params, stats = NETS[name][1](jti.state_dict_to_numpy(ref.state_dict()))
        out[name] = dict(ref=ref, params=params, stats=stats,
                         sd=tti.IMPORTERS[name](ref.state_dict()))
    return out


@pytest.mark.parametrize("name", list(NETS))
def test_loader_matches_jax_importer(imported, batch_mode, name):
    """Key for key and bit for bit the JAX importer's tensors through
    `flax_to_state_dict`; the port's network built in "batch" mode loads
    them strictly (every key present, none extra, shapes equal)."""
    d = imported[name]
    ref_sd = W.flax_to_state_dict(d["params"], d["stats"])
    assert sorted(d["sd"]) == sorted(ref_sd)
    for k, v in ref_sd.items():
        assert d["sd"][k].dtype == torch.float32 and torch.equal(d["sd"][k], v), k
    net = NETS[name][3]()
    net.load_state_dict(d["sd"], strict=True)
    assert any(k.endswith("running_var") for k in d["sd"])
    assert not any("num_batches_tracked" in k for k in d["sd"])


def _port(name, d):
    net = NETS[name][3]()
    net.load_state_dict(d["sd"], strict=True)
    return net.eval()


def _flax(name, d, *args, **kw):
    with F.jax_fused_kernels():
        return NETS[name][2]().apply({"params": d["params"], "batch_stats": d["stats"]},
                                     *args, **kw)


def _close(got, ref, what, rows=None):
    got, ref = F.np_(got), np.asarray(ref)
    if rows is not None:
        got, ref = got[:, :rows], ref[:, :rows]
    F.assert_close(got, ref, atol=EVAL, rtol=EVAL, what=what)


@pytest.mark.parametrize("name", ["joint", "mask", "skin"])
def test_rigging_network_matches_flax_and_oracle(imported, inputs, batch_mode, name):
    """JointNetMotion, MaskNetMotion, SkinMotion in inference: the motion
    features, their aggregate and the head against flax, and the head
    against the reference oracle on the unpadded mesh."""
    d, x = imported[name], inputs
    got = _port(name, d)(*_args(name, x, False))
    ref = _flax(name, d, *_args(name, x, True))
    V = x["V"]
    for g, r, what in zip(got, ref, ("motion_all", "motion_aggr", "head")):
        _close(g, r, f"{name} {what}", V)
    tpl, geo = (torch.as_tensor(np.asarray(e), dtype=torch.long) for e in (x["tpl"], x["geo"]))
    pos, flow = torch.as_tensor(x["verts"]), torch.as_tensor(x["flow"][0, :V])
    with torch.no_grad():
        if name == "skin":
            oracle = d["ref"](pos, torch.as_tensor(x["skin"][0, :V]), flow, tpl, geo)
        else:
            oracle = d["ref"](pos, flow, tpl, geo)
    _close(got[2][0, :V], oracle, f"{name} against the oracle")


@pytest.mark.parametrize("name", ["bone", "root"])
def test_skeleton_network_matches_flax(imported, inputs, batch_mode, name):
    """BoneNet's pair logits and RootNet's joint logits in inference, the
    PointNet++ joint stages included (exact top-k radius grouping)."""
    d = imported[name]
    jnb.set_topk_mode("exact")
    try:
        ref = _flax(name, d, *_args(name, inputs, True))
    finally:
        jnb.set_topk_mode("auto")
    got = _port(name, d)(*_args(name, inputs, False))
    _close(got, ref, name)


def test_corrnet_matches_flax_and_oracle(imported, inputs, batch_mode):
    """CorrNet whole in inference (mesh and point embeddings, the vismask
    logits over K2's 1-NN, the temperature), and its mesh encoder against
    MeshEncoderOracle loaded from the reference's mesh-branch keys."""
    d, x = imported["corr"], inputs
    V = x["V"]
    jnb.set_topk_mode("exact")
    try:
        ref = _flax("corr", d, *_args("corr", x, True))
    finally:
        jnb.set_topk_mode("auto")
    net = _port("corr", d)
    got = net(*_args("corr", x, False))
    for g, r, what, rows in zip(got[:3], ref[:3], ("vtx_f", "pts_f", "vismask"), (V, None, V)):
        _close(g, r, f"corr {what}", rows)
    assert float(got[3]) == float(ref[3])
    oracle = MeshEncoderOracle()
    sd = d["ref"].state_dict()
    oracle.load_state_dict({k: v for k, v in sd.items() if k.startswith("vtx_")}, strict=True)
    tpl, geo = (torch.as_tensor(np.asarray(e), dtype=torch.long) for e in (x["tpl"], x["geo"]))
    with torch.no_grad():
        _close(got[0][0, :V], oracle.eval()(torch.as_tensor(x["verts"]), tpl, geo),
               "mesh encoder against the oracle")


def test_deformnet_matches_flax_and_oracle(imported, inputs, batch_mode, monkeypatch):
    """DeformNet in inference: its CorrNet outputs whole, its flow given the
    flax CorrNet outputs (the voting and completion over K2, then
    GCNDeform), and `completing` against GCNDeformOracle on the unpadded
    mesh."""
    d, x = imported["deform"], inputs
    V = x["V"]
    jnb.set_topk_mode("exact")
    try:
        (flow, vtx_f, pts_f, vis, tau), st = _flax(
            "deform", d, *_args("deform", x, True),
            capture_intermediates=lambda mdl, _: mdl.name == "lin_vismask",
            mutable=["intermediates"])
    finally:
        jnb.set_topk_mode("auto")
    vis_logits = st["intermediates"]["corr_extractor"]["lin_vismask"]["__call__"][0]
    net = _port("deform", d)
    corr = net.corr_extractor
    got = corr(*_args("deform", x, False))
    for g, r, what, rows in zip(got[:3], (vtx_f, pts_f, vis_logits),
                                ("vtx_f", "pts_f", "vismask"), (V, None, V)):
        _close(g, r, f"deform {what}", rows)
    for mod, val in ((corr.mesh_enc, vtx_f), (corr.pts_enc, pts_f),
                     (corr.lin_vismask, vis_logits)):
        monkeypatch.setattr(mod, "forward", lambda *_, v=val: torch.as_tensor(np.asarray(v)))
    out = net(*_args("deform", x, False))
    _close(out[0], flow, "deform flow", V)
    _close(out[3], vis, "deform vismask", V)
    monkeypatch.undo()
    feat = torch.as_tensor(np.random.default_rng(1).standard_normal((1, 128, 4)),
                           dtype=torch.float32)
    tm = x["tm"]
    got = net.completing(tm.verts, feat, tm)
    tpl, geo = (torch.as_tensor(np.asarray(e), dtype=torch.long) for e in (x["tpl"], x["geo"]))
    with torch.no_grad():
        oracle = d["ref"].completing(torch.as_tensor(x["verts"]), feat[0, :V], tpl, geo)
    _close(got[0, :V], oracle, "completing against the oracle")
