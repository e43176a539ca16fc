"""Rigging nets: temporal attention, motion trunks, joint/mask/skin heads.
Counterpart of morig_tpu/nn/rignet.py (attn aggregation, per-keyframe loop:
the shared trunk runs once per keyframe over its 3-channel flow slice)."""
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, V, T, C = x.shape
        H, D = self.num_heads, self.hidden_size
        seq = torch.cat([self.cls_token.expand(B, V, 1, C), x], 2)      # (B,V,T+1,C)
        q, k, v = (w(seq).reshape(B, V, T + 1, H, D)
                   for w in (self.w_qs, self.w_ks, self.w_vs))
        attn = torch.einsum("bvthd,bvshd->bvhts", q, k) / math.sqrt(D)
        attn = torch.softmax(attn, dim=-1)
        res = torch.einsum("bvhts,bvshd->bvthd", attn, v).reshape(B, V, T + 1, H * D)
        return self.feedforward(self.w_o(res)[:, :, 0, :])


class GCNRig(nn.Module):
    """3 x GCUMotion + global max + zero-initialized transform head."""

    def __init__(self, feat_in: int, chn_output: int):
        super().__init__()
        self.gcu_1 = GCUMotion(3, feat_in, 64)
        self.gcu_2 = GCUMotion(3, 64, 256)
        self.gcu_3 = GCUMotion(3, 256, 512)
        self.mlp_glb = MLP(832, [1024])
        self.mlp_transform = MLPHead(1024 + 3 + feat_in + 832, [1024, 256], chn_output,
                                     zero_init=True)

    def forward(self, pos, feature, mesh: MeshBatch):
        x1 = self.gcu_1(pos, feature, mesh)
        x2 = self.gcu_2(pos, x1, mesh)
        x3 = self.gcu_3(pos, x2, mesh)
        skips = torch.cat([x1, x2, x3], -1)
        glb = nbk.masked_max(self.mlp_glb(skips), mesh.vert_mask, dim=1)
        glb = glb[:, None, :].expand(-1, skips.shape[1], -1)
        return self.mlp_transform(torch.cat([glb, mesh.verts, feature, skips], -1))


class MotionAggregator(nn.Module):
    """Shared per-keyframe motion trunk + temporal attention.  input_flow is
    (B,V,3T), frame-major in the channel.  Returns (motion_all (B,V,T,M),
    L2-normalized aggregate (B,V,attn_output))."""

    def __init__(self, num_keyframes: int = 5, motion_dim: int = 32, attn_output: int = 64):
        super().__init__()
        self.num_keyframes = num_keyframes
        self.motionNet = GCNRig(3, motion_dim)
        self.aggregator = TemporalAttn(motion_dim, output_size=attn_output)

    def forward(self, input_flow: torch.Tensor, mesh: MeshBatch):
        feats = [l2_normalize(self.motionNet(mesh.verts, input_flow[..., 3 * t:3 * t + 3], mesh))
                 for t in range(self.num_keyframes)]
        motion_all = torch.stack(feats, 2)
        return motion_all, l2_normalize(self.aggregator(motion_all))


class JointNetMotion(nn.Module):
    """Per-vertex displacement toward the nearest joint.  Returns
    (motion_all, motion_aggr, shift (B,V,3))."""

    def __init__(self, num_keyframes: int = 5, motion_dim: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.motion = MotionAggregator(num_keyframes, motion_dim, 64)
        self.jointnet = GCNRig(64, 3)
        init_parameters(self, default_generator(generator))

    def forward(self, input_flow, mesh: MeshBatch):
        motion_all, motion_aggr = self.motion(input_flow, mesh)
        return motion_all, motion_aggr, self.jointnet(mesh.verts, motion_aggr, mesh)


class MaskNetMotion(nn.Module):
    """Per-vertex joint-attention logit.  Returns (motion_all, motion_aggr,
    logits (B,V,1))."""

    def __init__(self, num_keyframes: int = 5, motion_dim: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.motion = MotionAggregator(num_keyframes, motion_dim, 64)
        self.masknet = GCNRig(64, 1)
        init_parameters(self, default_generator(generator))

    def forward(self, input_flow, mesh: MeshBatch):
        motion_all, motion_aggr = self.motion(input_flow, mesh)
        return motion_all, motion_aggr, self.masknet(mesh.verts, motion_aggr, mesh)


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
                 use_Lf: bool = False):
        super().__init__()
        self.nearest_bone, self.use_Dg, self.use_Lf = nearest_bone, use_Dg, use_Lf
        raw = 3 + nearest_bone * (6 + int(use_Dg) + int(use_Lf))
        self.gcu1 = GCUMotion(raw, motion_dim, 256, dim_pos_feat=64)
        self.multi_layer_transform2 = MLP(256, [512, 1024])
        self.gcu2 = GCUMotion(raw, 256, 256, dim_pos_feat=64)
        self.gcu3 = GCUMotion(raw, 256, 256, dim_pos_feat=64)
        self.cls_branch = MLPHead(256 + 1024, [1024, 512], nearest_bone, zero_init=True)

    def forward(self, skin_input, motion, mesh: MeshBatch):
        samples = slice_skin_descriptor(skin_input, self.nearest_bone, self.use_Dg, self.use_Lf)
        raw = torch.cat([mesh.verts, samples], -1)
        x1 = self.gcu1(raw, motion, mesh)
        xg = nbk.masked_max(self.multi_layer_transform2(x1), mesh.vert_mask, dim=1)
        x2 = self.gcu2(raw, x1, mesh)
        x3 = self.gcu3(raw, x2, mesh)
        xg = xg[:, None, :].expand(-1, x3.shape[1], -1)
        return self.cls_branch(torch.cat([x3, xg], -1))


class SkinMotion(nn.Module):
    """Motion features + temporal attention + skinning classifier.  Returns
    (motion_all, motion_aggr, logits (B,V,K))."""

    def __init__(self, nearest_bone: int = 5, use_Dg: bool = False, use_Lf: bool = False,
                 num_keyframes: int = 5, motion_dim: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.motion = MotionAggregator(num_keyframes, motion_dim, motion_dim)
        self.skinNet = SkinNetInner(motion_dim, nearest_bone, use_Dg, use_Lf)
        init_parameters(self, default_generator(generator))

    def forward(self, skin_input, input_flow, mesh: MeshBatch):
        motion_all, motion_aggr = self.motion(input_flow, mesh)
        return motion_all, motion_aggr, self.skinNet(skin_input, motion_aggr, mesh)
