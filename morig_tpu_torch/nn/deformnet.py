"""DeformNet — per-vertex flow from a mesh and a target point cloud.
Counterpart of morig_tpu/nn/deformnet.py: correspondence embeddings, visible
voting over the k most similar points, invisible completion from the most
similar visible vertices, GCN refinement.  `train` selects the training
numerics throughout (fp32 matmuls, every edge layer through K1 + K6, plain
gathers in PointNet++) and `generator` the extractor's random FPS starts;
both kNN calls stay on K2, whose autograd carries the gradients of the
embeddings and of the gathered flow when the extractor trains."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from morig_tpu_torch.core.batch import MeshBatch, PointBatch
from morig_tpu_torch.kernels import neighbors as nbk
from morig_tpu_torch.kernels.knn_fused import knn_batched
from morig_tpu_torch.nn.corrnet import CorrNet
from morig_tpu_torch.nn.gcu import GCUMotion
from morig_tpu_torch.nn.mlp import MLP, MLPHead, default_generator, init_parameters


class GCNDeform(nn.Module):
    """3 x GCUMotion + global max + zero-initialized transform head."""

    def __init__(self, feat_in: int, chn_output: int = 3):
        super().__init__()
        self.gcu_1 = GCUMotion(3, feat_in, 128)
        self.gcu_2 = GCUMotion(3, 128, 256)
        self.gcu_3 = GCUMotion(3, 256, 512)
        self.mlp_glb = MLP(896, [1024])
        self.mlp_transform = MLPHead(1024 + 3 + feat_in + 896, [1024, 256], chn_output,
                                     zero_init=True)

    def forward(self, pos, feature, mesh: MeshBatch, train: bool = False):
        x1 = self.gcu_1(pos, feature, mesh, train)
        x2 = self.gcu_2(pos, x1, mesh, train)
        x3 = self.gcu_3(pos, x2, mesh, train)
        skips = torch.cat([x1, x2, x3], -1)
        glb = nbk.masked_max(self.mlp_glb(skips, mesh.vert_mask, train), mesh.vert_mask, dim=1)
        glb = glb[:, None, :].expand(-1, skips.shape[1], -1)
        return self.mlp_transform(torch.cat([glb, pos, feature, skips], -1), mesh.vert_mask,
                                  train)


def minmax_normalize(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-sample min-max normalization over valid entries of (B, V)."""
    mx = nbk.masked_max(x, mask, dim=1)[:, None]
    mn = -nbk.masked_max(-x, mask, dim=1)[:, None]
    return (x - mn) / torch.clamp(mx - mn, min=eps)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.where(den.abs() > 1e-8, den, torch.full_like(den, 1e-8))


class DeformNet(nn.Module):
    """Returns (pred_flow (B,V,3), vtx_feature, pts_feature, vismask (B,V),
    tau); `mesh_only` returns the per-mesh embedding alone."""

    def __init__(self, num_interp: int = 5, tau_init: float = 0.07,
                 output_feature: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_interp = num_interp
        self.corr_extractor = CorrNet(output_feature, tau_init)
        self.completing = GCNDeform(4, 3)
        init_parameters(self, default_generator(generator))

    def forward(self, mesh: MeshBatch, points: Optional[PointBatch], train: bool = False,
                generator: Optional[torch.Generator] = None,
                vtx_f: Optional[torch.Tensor] = None, mesh_only: bool = False):
        if mesh_only:
            return self.corr_extractor(mesh, points, train, mesh_only=True)
        vtx_f, pts_f, vis_logits, tau = self.corr_extractor(mesh, points, train, True, generator,
                                                            vtx_f=vtx_f)
        vis = minmax_normalize(torch.sigmoid(vis_logits[..., 0]), mesh.vert_mask)

        # visible voting: flow from the k most similar points (kernel K2)
        k = self.num_interp
        _, sim, nn_pts = knn_batched(vtx_f, pts_f, k, points.pts_mask,
                                     gather_values=points.pts)
        sim = torch.where(sim > nbk.NEG / 2, sim, torch.zeros_like(sim))
        offsets = nn_pts - mesh.verts[:, :, None, :]
        w = sim * vis[:, :, None]
        flow_init = _safe_div((offsets * w[..., None]).sum(2), w.sum(-1, keepdim=True))

        # invisible completion from the most similar visible vertices (K2)
        visible = (vis >= 0.5) & mesh.vert_mask
        _, sim2, vis_flow = knn_batched(vtx_f, vtx_f, k, visible, gather_values=flow_init)
        sim2 = torch.where(sim2 > nbk.NEG / 2, sim2, torch.zeros_like(sim2))
        invis_flow = _safe_div((vis_flow * sim2[..., None]).sum(2), sim2.sum(-1, keepdim=True))
        any_visible = visible.any(dim=1)[:, None, None]
        flow_init = torch.where(visible[..., None] | ~any_visible, flow_init, invis_flow)

        l1_points = torch.cat([flow_init, vis[..., None]], -1)
        pred_flow = self.completing(mesh.verts, l1_points, mesh, train)
        return pred_flow, vtx_f, pts_f, vis, tau
