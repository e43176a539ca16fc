"""Rigging nets: temporal attention, motion trunks, joint/mask/skin heads.
Counterpart of morig_tpu/nn/rignet.py: the per-keyframe loop (the shared
trunk runs once per keyframe over its 3-channel flow slice), temporal
aggregation by attention (`attn`), `mean` or `max`, and `width_scale`,
which shrinks every hidden width c to max(8, int(c * width_scale)) as the
JAX modules do (the reference widths at 1.0).  `train` selects the training
numerics (fp32 matmuls, every edge layer through K1 + K6 where the kernels
take its widths).  In "batch" norm mode the per-keyframe loop takes batch
statistics per keyframe, as the reference does, and the shared trunk
updates its running statistics once per keyframe, T times a step."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from morig_tpu_torch.core.batch import MeshBatch
from morig_tpu_torch.kernels import neighbors as nbk
from morig_tpu_torch.nn.corrnet import l2_normalize
from morig_tpu_torch.nn.gcu import GCUMotion
from morig_tpu_torch.nn.mlp import MLP, Dense, MLPHead, default_generator, init_parameters

AGGR_METHODS = ("attn", "mean", "max")


def scaled(c: int, width_scale: float) -> int:
    """A hidden width under `width_scale`: max(8, int(c * width_scale))."""
    return max(8, int(c * width_scale))


class TemporalAttn(nn.Module):
    """One multi-head attention block over T keyframe tokens + a learned CLS
    token; the CLS position's output is the aggregate.  fp32 throughout."""

    def __init__(self, in_dim: int, num_heads: int = 2, hidden_size: int = 64,
                 dim_feedforward: int = 512, output_size: int = 64):
        super().__init__()
        self.num_heads, self.hidden_size = num_heads, hidden_size
        self.cls_token = nn.Parameter(torch.empty(in_dim))
        hd = num_heads * hidden_size
        self.w_qs = Dense(in_dim, hd, bias=False)
        self.w_ks = Dense(in_dim, hd, bias=False)
        self.w_vs = Dense(in_dim, hd, bias=False)
        self.w_o = Dense(hd, hidden_size, bias=False)
        self.feedforward = MLP(hidden_size, [dim_feedforward, output_size])

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.cls_token, 0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor, vert_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        B, V, T, C = x.shape
        H, D = self.num_heads, self.hidden_size
        seq = torch.cat([self.cls_token.expand(B, V, 1, C), x], 2)      # (B,V,T+1,C)
        q, k, v = (w(seq).reshape(B, V, T + 1, H, D)
                   for w in (self.w_qs, self.w_ks, self.w_vs))
        attn = torch.einsum("bvthd,bvshd->bvhts", q, k) / math.sqrt(D)
        attn = torch.softmax(attn, dim=-1)
        res = torch.einsum("bvhts,bvshd->bvthd", attn, v).reshape(B, V, T + 1, H * D)
        return self.feedforward(self.w_o(res)[:, :, 0, :], vert_mask, train)


class GCNRig(nn.Module):
    """3 x GCUMotion + global max + zero-initialized transform head."""

    def __init__(self, feat_in: int, chn_output: int, width_scale: float = 1.0):
        super().__init__()
        w = lambda c: scaled(c, width_scale)
        self.gcu_1 = GCUMotion(3, feat_in, w(64))
        self.gcu_2 = GCUMotion(3, w(64), w(256))
        self.gcu_3 = GCUMotion(3, w(256), w(512))
        skips = w(64) + w(256) + w(512)
        self.mlp_glb = MLP(skips, [w(1024)])
        self.mlp_transform = MLPHead(w(1024) + 3 + feat_in + skips, [w(1024), w(256)],
                                     chn_output, zero_init=True)

    def forward(self, pos, feature, mesh: MeshBatch, train: bool = False):
        x1 = self.gcu_1(pos, feature, mesh, train)
        x2 = self.gcu_2(pos, x1, mesh, train)
        x3 = self.gcu_3(pos, x2, mesh, train)
        skips = torch.cat([x1, x2, x3], -1)
        glb = nbk.masked_max(self.mlp_glb(skips, mesh.vert_mask, train), mesh.vert_mask, dim=1)
        glb = glb[:, None, :].expand(-1, skips.shape[1], -1)
        return self.mlp_transform(torch.cat([glb, mesh.verts, feature, skips], -1), mesh.vert_mask,
                                  train)


class MotionAggregator(nn.Module):
    """Shared per-keyframe motion trunk + temporal aggregation.  input_flow
    is (B,V,3T), frame-major in the channel.  Returns (motion_all
    (B,V,T,motion_dim), the L2-normalized aggregate: (B,V,attn_output) with
    `attn`, (B,V,motion_dim) with `mean` or `max`)."""

    def __init__(self, num_keyframes: int = 5, motion_dim: int = 32, aggr_method: str = "attn",
                 attn_output: int = 64, width_scale: float = 1.0):
        super().__init__()
        if aggr_method not in AGGR_METHODS:
            raise NotImplementedError(aggr_method)
        self.num_keyframes, self.aggr_method = num_keyframes, aggr_method
        self.out_dim = attn_output if aggr_method == "attn" else motion_dim
        self.motionNet = GCNRig(3, motion_dim, width_scale)
        if aggr_method == "attn":
            self.aggregator = TemporalAttn(motion_dim, 2, scaled(64, width_scale),
                                           scaled(512, width_scale), attn_output)

    def aggregate(self, motion_all: torch.Tensor, vert_mask: Optional[torch.Tensor] = None,
                  train: bool = False) -> torch.Tensor:
        """(B,V,T,M) per-keyframe features -> the L2-normalized aggregate."""
        if self.aggr_method == "attn":
            aggr = self.aggregator(motion_all, vert_mask, train)
        elif self.aggr_method == "mean":
            aggr = motion_all.mean(2)
        else:
            aggr = motion_all.amax(2)
        return l2_normalize(aggr)

    def forward(self, input_flow: torch.Tensor, mesh: MeshBatch, train: bool = False):
        feats = [l2_normalize(self.motionNet(mesh.verts, input_flow[..., 3 * t:3 * t + 3], mesh,
                                             train))
                 for t in range(self.num_keyframes)]
        motion_all = torch.stack(feats, 2)
        return motion_all, self.aggregate(motion_all, mesh.vert_mask, train)


class JointNetMotion(nn.Module):
    """Per-vertex displacement toward the nearest joint.  Returns
    (motion_all, motion_aggr, shift (B,V,3))."""

    def __init__(self, num_keyframes: int = 5, motion_dim: int = 32, aggr_method: str = "attn",
                 width_scale: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.motion = MotionAggregator(num_keyframes, motion_dim, aggr_method, 64, width_scale)
        self.jointnet = GCNRig(self.motion.out_dim, 3, width_scale)
        init_parameters(self, default_generator(generator))

    def forward(self, input_flow, mesh: MeshBatch, train: bool = False):
        motion_all, motion_aggr = self.motion(input_flow, mesh, train)
        return motion_all, motion_aggr, self.jointnet(mesh.verts, motion_aggr, mesh, train)


class MaskNetMotion(nn.Module):
    """Per-vertex joint-attention logit.  Returns (motion_all, motion_aggr,
    logits (B,V,1))."""

    def __init__(self, num_keyframes: int = 5, motion_dim: int = 32, aggr_method: str = "attn",
                 width_scale: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.motion = MotionAggregator(num_keyframes, motion_dim, aggr_method, 64, width_scale)
        self.masknet = GCNRig(self.motion.out_dim, 1, width_scale)
        init_parameters(self, default_generator(generator))

    def forward(self, input_flow, mesh: MeshBatch, train: bool = False):
        motion_all, motion_aggr = self.motion(input_flow, mesh, train)
        return motion_all, motion_aggr, self.masknet(mesh.verts, motion_aggr, mesh, train)


def slice_skin_descriptor(samples: torch.Tensor, nearest_bone: int,
                          use_Dg: bool, use_Lf: bool) -> torch.Tensor:
    """Per-bone columns of the packed (..., K*8) descriptor: 6 endpoint
    coordinates, then 1/distance if use_Dg, then isleaf if use_Lf."""
    K = nearest_bone
    x = samples[..., :K * 8].reshape(samples.shape[:-1] + (K, 8))
    cols = [0, 1, 2, 3, 4, 5] + ([6] if use_Dg else []) + ([7] if use_Lf else [])
    return x[..., cols].reshape(samples.shape[:-1] + (K * len(cols),))


class SkinNetInner(nn.Module):
    """Skinning classifier over the K nearest bones; the bone descriptor rides
    the GCUMotion position channel."""

    def __init__(self, motion_dim: int, nearest_bone: int = 5, use_Dg: bool = False,
                 use_Lf: bool = False, width_scale: float = 1.0):
        super().__init__()
        self.nearest_bone, self.use_Dg, self.use_Lf = nearest_bone, use_Dg, use_Lf
        w = lambda c: scaled(c, width_scale)
        raw = 3 + nearest_bone * (6 + int(use_Dg) + int(use_Lf))
        self.gcu1 = GCUMotion(raw, motion_dim, w(256), dim_pos_feat=64)
        self.multi_layer_transform2 = MLP(w(256), [w(512), w(1024)])
        self.gcu2 = GCUMotion(raw, w(256), w(256), dim_pos_feat=64)
        self.gcu3 = GCUMotion(raw, w(256), w(256), dim_pos_feat=64)
        self.cls_branch = MLPHead(w(256) + w(1024), [w(1024), w(512)], nearest_bone,
                                  zero_init=True)

    def forward(self, skin_input, motion, mesh: MeshBatch, train: bool = False):
        samples = slice_skin_descriptor(skin_input, self.nearest_bone, self.use_Dg, self.use_Lf)
        raw = torch.cat([mesh.verts, samples], -1)
        x1 = self.gcu1(raw, motion, mesh, train)
        xg = nbk.masked_max(self.multi_layer_transform2(x1, mesh.vert_mask, train), mesh.vert_mask,
                            dim=1)
        x2 = self.gcu2(raw, x1, mesh, train)
        x3 = self.gcu3(raw, x2, mesh, train)
        xg = xg[:, None, :].expand(-1, x3.shape[1], -1)
        return self.cls_branch(torch.cat([x3, xg], -1), mesh.vert_mask, train)


class SkinMotion(nn.Module):
    """Motion features + temporal attention + skinning classifier.  Returns
    (motion_all, motion_aggr, logits (B,V,K))."""

    def __init__(self, nearest_bone: int = 5, use_Dg: bool = False, use_Lf: bool = False,
                 num_keyframes: int = 5, motion_dim: int = 32, width_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.motion = MotionAggregator(num_keyframes, motion_dim, "attn", motion_dim,
                                       width_scale)
        self.skinNet = SkinNetInner(motion_dim, nearest_bone, use_Dg, use_Lf, width_scale)
        init_parameters(self, default_generator(generator))

    def forward(self, skin_input, input_flow, mesh: MeshBatch, train: bool = False):
        motion_all, motion_aggr = self.motion(input_flow, mesh, train)
        return motion_all, motion_aggr, self.skinNet(skin_input, motion_aggr, mesh, train)
