"""The reference's PyTorch state dicts -> the port's state dicts, for
networks built in the "batch" norm mode (`nn.mlp.set_default_norm("batch")`).
Counterpart of morig_tpu/eval/torch_import.py, which maps the same keys
onto flax trees; here they land on the port's module names.

The reference's key layout:
  * MLP([c0, ..., cn]) is Seq(Seq(Lin, ReLU, BN1d), ...): stage i has
    `{p}.{i}.0.weight/bias` (Linear) and `{p}.{i}.2.weight/bias/
    running_mean/running_var` (BatchNorm1d) -> `dense_i`, `bn_i`;
  * EdgeConv keeps its message MLP as `nn_pos`, EdgeConvMotion as `nn_x`
    and `nn_pos`; GCU / GCUMotion hold `edge_conv_tpl`, `edge_conv_geo`
    and `mlp`;
  * heads are Seq(MLP, Lin): `{p}.0.*` the MLP, `{p}.1.*` the Linear ->
    `mlp`, `out`;
  * PyG's PointConv keeps the SA message MLP as `conv.local_nn`; the
    global SA and FP modules theirs as `nn`.

The one map that is not a rename is the first edge layer: the reference's
Linear acts on [x_i ; x_j - x_i] with W = [W1 | W2], which equals
(W1 - W2) x_i + W2 x_j + b, so `lin_self` gets W1 - W2 with the bias and
`lin_nbr` W2.  The reference's misspellings map to the port's names:
`temprature`, `mlp_tramsform`, `aggragator`, `multi_layer_tranform2`.
`num_batches_tracked` is not read.  Every function takes `sd`, a flat
mapping of numpy arrays or tensors, and returns a dict of fp32 tensors
that loads with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

Out = dict[str, torch.Tensor]


def _j(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(sd: Mapping, src: str, dst: str, out: Out, bias: bool = True) -> None:
    out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
    if bias:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def _bn(sd: Mapping, src: str, dst: str, out: Out) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{name}"] = _t(sd[f"{src}.{name}"])


def _num_stages(sd: Mapping, prefix: str) -> int:
    n = 0
    while _j(prefix, f"{n}.0.weight") in sd:
        n += 1
    if n == 0:
        raise KeyError(f"no MLP stages under {prefix!r}")
    return n


def import_mlp(sd: Mapping, src: str, dst: str, out: Out) -> None:
    """Reference MLP -> nn.mlp.MLP: dense_i and bn_i."""
    for i in range(_num_stages(sd, src)):
        _lin(sd, _j(src, f"{i}.0"), _j(dst, f"dense_{i}"), out)
        if _j(src, f"{i}.2.weight") in sd:
            _bn(sd, _j(src, f"{i}.2"), _j(dst, f"bn_{i}"), out)


def import_mlp_head(sd: Mapping, src: str, dst: str, out: Out) -> None:
    """Reference Seq(MLP, Lin) -> nn.mlp.MLPHead {mlp, out}."""
    import_mlp(sd, _j(src, "0"), _j(dst, "mlp"), out)
    _lin(sd, _j(src, "1"), _j(dst, "out"), out)


def import_edge_mlp(sd: Mapping, src: str, dst: str, out: Out) -> None:
    """Reference edge-message MLP -> nn.gcu.EdgeMLP: stage 0 split into
    lin_self / lin_nbr, later stages dense_i, each BN norm_i.bn."""
    W = np.asarray(_t(sd[_j(src, "0.0.weight")]))                  # (H, 2C)
    C = W.shape[1] // 2
    W1, W2 = W[:, :C], W[:, C:]
    out[_j(dst, "lin_self.weight")] = torch.from_numpy(np.ascontiguousarray(W1 - W2))
    out[_j(dst, "lin_self.bias")] = _t(sd[_j(src, "0.0.bias")])
    out[_j(dst, "lin_nbr.weight")] = torch.from_numpy(np.ascontiguousarray(W2))
    for i in range(_num_stages(sd, src)):
        if i > 0:
            _lin(sd, _j(src, f"{i}.0"), _j(dst, f"dense_{i}"), out)
        if _j(src, f"{i}.2.weight") in sd:
            _bn(sd, _j(src, f"{i}.2"), _j(dst, f"norm_{i}.bn"), out)


def import_gcu(sd: Mapping, src: str, dst: str, out: Out, motion: bool = False) -> None:
    """Reference GCU (or GCUMotion with `motion`) -> nn.gcu.GCU / GCUMotion."""
    for conv in ("edge_conv_tpl", "edge_conv_geo"):
        for edge in (("nn_x", "nn_pos") if motion else ("nn_pos",)):
            import_edge_mlp(sd, _j(src, f"{conv}.{edge}"), _j(dst, f"{conv}.{edge}"), out)
    import_mlp(sd, _j(src, "mlp"), _j(dst, "mlp"), out)


def _import_modules(sd: Mapping, src: str, dst: str, out: Out, table) -> None:
    """(port name, reference name, importer) rows under src / dst."""
    for port_name, ref_name, importer in table:
        importer(sd, _j(src, ref_name), _j(dst, port_name), out)


def _sa(sd, src, dst, out):
    import_mlp(sd, _j(src, "conv.local_nn"), _j(dst, "conv"), out)


def _nn(sd, src, dst, out):
    import_mlp(sd, _j(src, "nn"), _j(dst, "nn"), out)


def _gcu(sd, src, dst, out):
    import_gcu(sd, src, dst, out)


def _gcu_motion(sd, src, dst, out):
    import_gcu(sd, src, dst, out, motion=True)


def import_corrnet(sd: Mapping, src: str = "", dst: str = "") -> Out:
    """Reference CorrNet -> nn.corrnet.CorrNet: the mesh and point branches,
    the vismask head and the temperature (a (1,) tensor -> a scalar)."""
    out: Out = {_j(dst, "temperature"): _t(sd[_j(src, "temprature")]).reshape(())}
    mesh = _j(dst, "mesh_enc")
    _import_modules(sd, src, mesh, out, [(f"vtx_gcu_{i}", f"vtx_gcu_{i}", _gcu)
                                         for i in range(1, 5)])
    import_mlp(sd, _j(src, "vtx_mlp_glb"), _j(mesh, "vtx_mlp_glb"), out)
    import_mlp_head(sd, _j(src, "vtx_mlp"), _j(mesh, "vtx_mlp"), out)
    pts = _j(dst, "pts_enc")
    _import_modules(sd, src, pts, out, [
        ("sa1", "pts_sa1_module", _sa), ("sa2", "pts_sa2_module", _sa),
        ("sa3", "pts_sa3_module", _sa), ("sa4", "pts_sa4_module", _nn),
        ("fp4", "pts_fp4_module", _nn), ("fp3", "pts_fp3_module", _nn),
        ("fp2", "pts_fp2_module", _nn), ("fp1", "pts_fp1_module", _nn)])
    import_mlp_head(sd, _j(src, "pts_mlp"), _j(pts, "pts_mlp"), out)
    import_mlp_head(sd, _j(src, "lin_vismask"), _j(dst, "lin_vismask"), out)
    return out


def import_gcn(sd: Mapping, src: str, dst: str, out: Out, head: str = "mlp_transform") -> None:
    """Reference GCNRig / GCNDeform -> nn.rignet.GCNRig / nn.deformnet.GCNDeform:
    three GCUMotion, mlp_glb and the transform head, whose reference name is
    `head` (GCNDeform's is `mlp_tramsform`)."""
    _import_modules(sd, src, dst, out, [(f"gcu_{i}", f"gcu_{i}", _gcu_motion) for i in (1, 2, 3)])
    import_mlp(sd, _j(src, "mlp_glb"), _j(dst, "mlp_glb"), out)
    import_mlp_head(sd, _j(src, head), _j(dst, "mlp_transform"), out)


def import_deformnet(sd: Mapping, src: str = "") -> Out:
    """Reference DeformNet -> nn.deformnet.DeformNet."""
    out = import_corrnet(sd, _j(src, "corr_extractor"), "corr_extractor")
    import_gcn(sd, _j(src, "completing"), "completing", out, head="mlp_tramsform")
    return out


def import_temporal_attn(sd: Mapping, src: str, dst: str, out: Out) -> None:
    """Reference TemporalAttn -> nn.rignet.TemporalAttn: its (1, 1, C)
    cls_token as (C,), the bias-free projections, the feedforward MLP."""
    out[_j(dst, "cls_token")] = _t(sd[_j(src, "cls_token")]).reshape(-1)
    for name in ("w_qs", "w_ks", "w_vs", "w_o"):
        _lin(sd, _j(src, name), _j(dst, name), out, bias=False)
    import_mlp(sd, _j(src, "feedforward"), _j(dst, "feedforward"), out)


def _import_motion(sd: Mapping, src: str, out: Out) -> None:
    """The shared motionNet and the `aggragator` of a rigging network ->
    its MotionAggregator `motion`."""
    import_gcn(sd, _j(src, "motionNet"), "motion.motionNet", out)
    import_temporal_attn(sd, _j(src, "aggragator"), "motion.aggregator", out)


def import_jointnet(sd: Mapping, src: str = "") -> Out:
    """Reference JointNetMotion (attention aggregation) -> nn.rignet.JointNetMotion."""
    out: Out = {}
    _import_motion(sd, src, out)
    import_gcn(sd, _j(src, "jointnet"), "jointnet", out)
    return out


def import_masknet(sd: Mapping, src: str = "") -> Out:
    """Reference MaskNetMotion -> nn.rignet.MaskNetMotion."""
    out: Out = {}
    _import_motion(sd, src, out)
    import_gcn(sd, _j(src, "masknet"), "masknet", out)
    return out


def import_skinmotion(sd: Mapping, src: str = "") -> Out:
    """Reference SkinMotion -> nn.rignet.SkinMotion; skinNet's
    `multi_layer_tranform2` is the port's multi_layer_transform2."""
    out: Out = {}
    _import_motion(sd, src, out)
    skin = _j(src, "skinNet")
    _import_modules(sd, skin, "skinNet", out, [(f"gcu{i}", f"gcu{i}", _gcu_motion)
                                               for i in (1, 2, 3)])
    import_mlp(sd, _j(skin, "multi_layer_tranform2"), "skinNet.multi_layer_transform2", out)
    import_mlp_head(sd, _j(skin, "cls_branch"), "skinNet.cls_branch", out)
    return out


def _import_shape_encoder(sd: Mapping, src: str, out: Out) -> None:
    _import_modules(sd, _j(src, "shape_encoder"), "shape_encoder", out,
                    [(f"gcu_{i}", f"gcu_{i}", _gcu) for i in (1, 2, 3)])
    import_mlp(sd, _j(src, "shape_encoder.mlp_glb"), "shape_encoder.mlp_glb", out)


def import_bonenet(sd: Mapping, src: str = "") -> Out:
    """Reference PairCls -> nn.bonenet.BoneNet: the joint encoder's
    `sa{1,2,3}_module_joints`, `expand_joint_feature` = Seq(MLP) and
    `mix_transform` = Seq(MLP, Dropout, Linear), whose Linear (index 2) is
    the port's `out`."""
    out: Out = {}
    _import_shape_encoder(sd, src, out)
    _import_modules(sd, _j(src, "joint_encoder"), "joint_encoder", out, [
        ("sa1", "sa1_module_joints", _sa), ("sa2", "sa2_module_joints", _sa),
        ("sa3", "sa3_module_joints", _nn)])
    import_mlp(sd, _j(src, "expand_joint_feature.0"), "expand_joint_feature", out)
    import_mlp(sd, _j(src, "mix_transform.0"), "mix_transform", out)
    _lin(sd, _j(src, "mix_transform.2"), "out", out)
    return out


def import_rootnet(sd: Mapping, src: str = "") -> Out:
    """Reference ROOTNET -> nn.bonenet.RootNet: the joint encoder's
    `sa{1,2,3}_joint` / `fp{1,2,3}_joint` are the port's top-level sa1..fp1,
    `back_layers` its head."""
    out: Out = {}
    _import_shape_encoder(sd, src, out)
    _import_modules(sd, _j(src, "joint_encoder"), "", out, [
        ("sa1", "sa1_joint", _sa), ("sa2", "sa2_joint", _sa), ("sa3", "sa3_joint", _nn),
        ("fp3", "fp3_joint", _nn), ("fp2", "fp2_joint", _nn), ("fp1", "fp1_joint", _nn)])
    import_mlp_head(sd, _j(src, "back_layers"), "back_layers", out)
    return out


# the rig DAG's networks (pipelines.rig_predict.NETS) and CorrNet
IMPORTERS = {"deform": import_deformnet, "joint": import_jointnet, "mask": import_masknet,
             "root": import_rootnet, "bone": import_bonenet, "skin": import_skinmotion,
             "corr": import_corrnet}
