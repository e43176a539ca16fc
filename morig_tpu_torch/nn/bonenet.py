"""BoneNet (pairwise connectivity) and RootNet (root classification).
Counterpart of morig_tpu/nn/bonenet.py.

`train` selects the training numerics down to every module: fp32 MLP
matmuls, the shape encoder's edge layers through K1 forward and K6
backward, plain indexed gathers in the PointNet++ stages (K3 at inference
only).  In training BoneNet also swaps the joints of each pair with
probability 1/2 (`permute`) and drops the mixed features after
`mix_transform` with probability `dropout` (flax semantics: the kept
entries are scaled by 1 / (1 - dropout)); both draws come from the
caller's generator.  In "batch" norm mode `expand_joint_feature` and
`mix_transform` take no mask, as in the JAX package and the reference:
padded pairs enter their batch statistics."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from morig_tpu_torch.core.batch import MeshBatch
from morig_tpu_torch.kernels import neighbors as nbk
from morig_tpu_torch.nn.gcu import GCU
from morig_tpu_torch.nn.mlp import MLP, Dense, MLPHead, default_generator, init_parameters
from morig_tpu_torch.nn.pointnet import FPModule, GlobalSAModule, SAModule
from morig_tpu_torch.parallel import rand as batch_rand


def _rand(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform [0, 1) draws from `generator` (the global generator when
    None) on the generator's device, moved to `device`; axis 0 is the
    batch (on a mesh drawn at the global batch, parallel/mesh.py `rand`)."""
    gen_dev = generator.device if generator is not None else device
    return batch_rand(shape, generator, gen_dev).to(device)


def pair_swap(generator: Optional[torch.Generator], B: int, P: int, device) -> torch.Tensor:
    """(B, P, 1) bool, each true with probability 1/2: the pairs whose two
    joints trade places."""
    return _rand((B, P, 1), generator, device) < 0.5


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout in training: each entry kept with probability
    1 - rate and scaled by 1 / (1 - rate), the others 0."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = _rand(x.shape, generator, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ShapeEncoder(nn.Module):
    """3 x GCU + global-max shape code (out_channels 64 for BoneNet, 128 for
    RootNet)."""

    def __init__(self, out_channels: int = 64):
        super().__init__()
        self.gcu_1 = GCU(3, 64)
        self.gcu_2 = GCU(64, 128)
        self.gcu_3 = GCU(128, 256)
        self.mlp_glb = MLP(448, [256, 64] if out_channels == 64 else [out_channels])

    def forward(self, mesh: MeshBatch, train: bool = False) -> torch.Tensor:
        x1 = self.gcu_1(mesh.verts, mesh, train)
        x2 = self.gcu_2(x1, mesh, train)
        x3 = self.gcu_3(x2, mesh, train)
        x4 = self.mlp_glb(torch.cat([x1, x2, x3], -1), mesh.vert_mask, train)
        return nbk.masked_max(x4, mesh.vert_mask, dim=1)


class JointSetEncoder(nn.Module):
    """Global joint-set code: SA stack over the joint cloud."""

    def __init__(self):
        super().__init__()
        self.sa1 = SAModule(0, 0.4, [64, 64, 128])
        self.sa2 = SAModule(128, 0.6, [128, 128, 256])
        self.sa3 = GlobalSAModule(256, [256, 256, 512, 256, 128])

    def forward(self, joints, joints_mask, train: bool = False) -> torch.Tensor:
        J = joints.shape[1]
        x1, p1, m1 = self.sa1(None, joints, joints_mask, J, train)
        x2, p2, m2 = self.sa2(x1, p1, m1, max(J // 3, 1), train)
        return self.sa3(x2, p2, m2, train)


class BoneNet(nn.Module):
    """Pairwise connectivity logits (B,P,1) for joint pairs (B,P,2) with
    pair attributes (B,P,2) = [distance, inside fraction]."""

    def __init__(self, generator: Optional[torch.Generator] = None, dropout: float = 0.7):
        super().__init__()
        self.dropout = dropout
        self.shape_encoder = ShapeEncoder(64)
        self.joint_encoder = JointSetEncoder()
        self.expand_joint_feature = MLP(8, [32, 64, 128, 256])
        self.mix_transform = MLP(64 + 128 + 256, [128, 64])
        self.out = Dense(64, 1, zero_init=True)
        init_parameters(self, default_generator(generator))

    def forward(self, mesh: MeshBatch, joints, joints_mask, pairs, pair_attr,
                train: bool = False, permute: bool = False,
                generator: Optional[torch.Generator] = None):
        """With `permute` in training the joints of each pair trade places
        where `pair_swap` draws true from `generator`, then the dropout mask
        is drawn.  `permute` mirrors the flax signature; BoneStage passes
        permute=train."""
        B, P, _ = pairs.shape
        shape_code = self.shape_encoder(mesh, train)
        joint_code = self.joint_encoder(joints, joints_mask, train)
        bsel = torch.arange(B, device=joints.device)[:, None]
        ja, jb = joints[bsel, pairs[..., 0]], joints[bsel, pairs[..., 1]]
        if permute and train:
            swap = pair_swap(generator, B, P, joints.device)
            ja, jb = torch.where(swap, jb, ja), torch.where(swap, ja, jb)
        mixed = torch.cat([shape_code[:, None, :].expand(-1, P, -1),
                           joint_code[:, None, :].expand(-1, P, -1),
                           self.expand_joint_feature(torch.cat([ja, jb, pair_attr], -1), None,
                                                     train)],
                          -1)
        h = self.mix_transform(mixed, None, train)
        if train:
            h = dropout(h, self.dropout, generator)
        return self.out(h)


class RootNet(nn.Module):
    """Per-joint root logits (B,J,1)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shape_encoder = ShapeEncoder(128)
        self.sa1 = SAModule(1, 0.4, [64, 64, 128])
        self.sa2 = SAModule(128, 0.6, [128, 128, 256])
        self.sa3 = GlobalSAModule(256, [256, 256, 512])
        self.fp3 = FPModule(1, 512, 256, [256, 256])
        self.fp2 = FPModule(3, 256, 128, [128, 128])
        self.fp1 = FPModule(3, 128, 1, [128, 128])
        self.back_layers = MLPHead(128 + 128, [200, 64], 1, zero_init=True)
        init_parameters(self, default_generator(generator))

    def forward(self, mesh: MeshBatch, joints, joints_mask, train: bool = False):
        J = joints.shape[1]
        shape_code = self.shape_encoder(mesh, train)
        x0 = joints[..., 0:1].abs()          # |x|: distance to the symmetry plane
        x1, p1, m1 = self.sa1(x0, joints, joints_mask, J, train)
        x2, p2, m2 = self.sa2(x1, p1, m1, max(J // 3, 1), train)
        xg = self.sa3(x2, p2, m2, train)
        f3, _, _ = self.fp3(xg, None, None, x2, p2, m2, train)
        f2, _, _ = self.fp2(f3, p2, m2, x1, p1, m1, train)
        f1, _, _ = self.fp1(f2, p1, m1, x0, joints, joints_mask, train)
        per_joint = torch.cat([shape_code[:, None, :].expand(-1, J, -1), f1], -1)
        return self.back_layers(per_joint, joints_mask, train)
