"""CorrNet — mesh/point correspondence embeddings + visibility head.
Counterpart of morig_tpu/nn/corrnet.py.  FPS starts at 0 at eval and where
no generator is given; in training with a generator, at a random valid
point per sample (`neighbors.random_starts`)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from morig_tpu_torch.core.batch import MeshBatch, PointBatch
from morig_tpu_torch.kernels import neighbors as nbk
from morig_tpu_torch.kernels.knn_fused import knn_batched
from morig_tpu_torch.nn.gcu import GCU
from morig_tpu_torch.nn.mlp import MLP, MLPHead
from morig_tpu_torch.nn.pointnet import FPModule, GlobalSAModule, SAModule


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


class MeshEncoder(nn.Module):
    """4 x GCU + skip concat + global max + projection head, L2-normalized."""

    def __init__(self, out_features: int = 64):
        super().__init__()
        self.vtx_gcu_1 = GCU(3, 32)
        self.vtx_gcu_2 = GCU(32, 64)
        self.vtx_gcu_3 = GCU(64, 256)
        self.vtx_gcu_4 = GCU(256, 512)
        self.vtx_mlp_glb = MLP(864, [1024])
        self.vtx_mlp = MLPHead(1024 + 3 + 864, [1024, 256], out_features)

    def forward(self, mesh: MeshBatch, train: bool = False) -> torch.Tensor:
        x1 = self.vtx_gcu_1(mesh.verts, mesh, train)
        x2 = self.vtx_gcu_2(x1, mesh, train)
        x3 = self.vtx_gcu_3(x2, mesh, train)
        x4 = self.vtx_gcu_4(x3, mesh, train)
        skips = torch.cat([x1, x2, x3, x4], -1)
        glb = nbk.masked_max(self.vtx_mlp_glb(skips, mesh.vert_mask, train), mesh.vert_mask, dim=1)
        glb = glb[:, None, :].expand(-1, skips.shape[1], -1)
        return l2_normalize(self.vtx_mlp(torch.cat([glb, mesh.verts, skips], -1), mesh.vert_mask,
                                          train))


class PointEncoder(nn.Module):
    """PointNet++ SA x 3 + GlobalSA + FP x 4 over a P-point cloud (P/2, P/8,
    P/32 centroids), L2-normalized."""

    def __init__(self, out_features: int = 64):
        super().__init__()
        self.sa1 = SAModule(0, 0.12, [32, 32, 64])
        self.sa2 = SAModule(64, 0.25, [64, 64, 128])
        self.sa3 = SAModule(128, 0.5, [256, 256, 256])
        self.sa4 = GlobalSAModule(256, [256, 256, 512])
        self.fp4 = FPModule(1, 512, 256, [256, 256])
        self.fp3 = FPModule(3, 256, 128, [256, 128])
        self.fp2 = FPModule(3, 128, 64, [128, 64])
        self.fp1 = FPModule(3, 64, 0, [64, 64])
        self.pts_mlp = MLPHead(64, [64], out_features)

    def forward(self, points: PointBatch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pos0, m0 = points.pts, points.pts_mask
        P = pos0.shape[1]
        x1, pos1, m1 = self.sa1(None, pos0, m0, P // 2, train, nbk.random_starts(generator, m0))
        x2, pos2, m2 = self.sa2(x1, pos1, m1, P // 8, train, nbk.random_starts(generator, m1))
        x3, pos3, m3 = self.sa3(x2, pos2, m2, P // 32, train, nbk.random_starts(generator, m2))
        xg = self.sa4(x3, pos3, m3, train)
        f4, _, _ = self.fp4(xg, None, None, x3, pos3, m3, train)
        f3, _, _ = self.fp3(f4, pos3, m3, x2, pos2, m2, train)
        f2, _, _ = self.fp2(f3, pos2, m2, x1, pos1, m1, train)
        f1, _, _ = self.fp1(f2, pos1, m1, None, pos0, m0, train)
        return l2_normalize(self.pts_mlp(f1, m0, train))


class CorrNet(nn.Module):
    """Returns (vtx_feature (B,V,C), pts_feature (B,P,C), vismask logits
    (B,V,1) or None without `train_vismask`, temperature); `mesh_only`
    returns the mesh embedding alone and `vtx_f` reuses a precomputed one.
    `train` selects the training numerics (fp32 matmuls, K1 + K6 edge
    layers, plain gathers) and `generator` the random FPS starts."""

    def __init__(self, output_feature: int = 64, tau_init: float = 0.07):
        super().__init__()
        self.tau_init = tau_init
        self.temperature = nn.Parameter(torch.empty(()))
        self.mesh_enc = MeshEncoder(output_feature)
        self.pts_enc = PointEncoder(output_feature)
        self.lin_vismask = MLPHead(2 * output_feature + 1, [256, 128, 64], 1, zero_init=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.temperature.fill_(self.tau_init)

    def forward(self, mesh: MeshBatch, points: Optional[PointBatch], train: bool = False,
                train_vismask: bool = True, generator: Optional[torch.Generator] = None,
                vtx_f: Optional[torch.Tensor] = None, mesh_only: bool = False):
        if mesh_only:
            return self.mesh_enc(mesh, train)
        if vtx_f is None:
            vtx_f = self.mesh_enc(mesh, train)
        pts_f = self.pts_enc(points, train, generator)
        vis_logits = None
        if train_vismask:
            # cosine 1-NN point feature per vertex (kernel K2, gathering
            # pts_f); the selection carries no gradient, the feature and the
            # similarity do
            _, _, nn_feat = knn_batched(vtx_f, pts_f, 1, points.pts_mask, gather_values=pts_f)
            nn_feat = nn_feat[:, :, 0, :]
            nn_sim = (vtx_f * nn_feat).sum(-1, keepdim=True)
            vis_logits = self.lin_vismask(torch.cat([vtx_f, nn_feat, nn_sim], -1), mesh.vert_mask,
                                          train)
        return vtx_f, pts_f, vis_logits, self.temperature
