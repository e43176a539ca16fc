"""Skeleton prediction for one mesh: joints -> RootNet / BoneNet -> Prim MST
-> Rig.  Counterpart of morig_tpu/pipelines/skeleton.py `predict_skeleton`,
taking the port's networks where the JAX function takes stage and state
pairs.

The networks give per-joint root logits and pairwise connection logits on
the device; the cost (-log p, raised for pairs that leave the volume and
halved between middle-plane joints) and the MST run on the host over the
J x J problem.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from morig_tpu_torch.data.skeleton_data import build_skel_sample
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.voxel import Voxels, segment_inside_fraction, vox_to_device
from morig_tpu_torch.nn.bonenet import BoneNet, RootNet


@torch.no_grad()
def predict_skeleton(mesh_entry: dict, joints: np.ndarray, root: RootNet, bone: BoneNet,
                     vox: Optional[Voxels] = None, symmetric: bool = False) -> sk.Rig:
    """A skeleton over `joints` (J, 3) for one mesh: root = argmax RootNet
    logit, edge cost = -log(sigmoid(BoneNet logit) + 1e-10) with the
    outside-bone penalty when `vox` is given, then Prim MST (the
    symmetry-aware variant with `symmetric`).  Runs on the networks'
    device."""
    device = next(root.parameters()).device
    sample = build_skel_sample([mesh_entry], [joints], voxes=[vox] if vox is not None else None,
                               max_joints=max(len(joints), 2), device=device)
    J = len(joints)

    root_logits = root(sample.mesh, sample.joints, sample.joints_mask)[0, :, 0].cpu().numpy()
    root_logits[~sample.joints_mask[0].cpu().numpy()] = -np.inf
    root_id = int(np.argmax(root_logits))

    pair_logits = bone(sample.mesh, sample.joints, sample.joints_mask, sample.pairs,
                       sample.pair_attr)[0, :, 0].cpu().numpy()
    pairs = sample.pairs[0].cpu().numpy()
    pmask = sample.pair_mask[0].cpu().numpy()
    prob = np.zeros((J, J))
    pr = pairs[pmask]
    prob[pr[:, 0], pr[:, 1]] = 1.0 / (1.0 + np.exp(-pair_logits[pmask]))
    prob = prob + prob.T
    cost = -np.log(prob + 1e-10)

    if vox is not None:
        grid = vox_to_device([vox], device)

        def frac_fn(starts, ends):
            s = torch.as_tensor(starts, dtype=torch.float32, device=device)[None]
            e = torch.as_tensor(ends, dtype=torch.float32, device=device)[None]
            return segment_inside_fraction(s, e, *grid)[0].cpu().numpy()

        cost = sk.increase_cost_for_outside_bone(cost, joints, frac_fn)

    if symmetric:
        parents, root_id = sk.prim_mst_symmetry(cost, root_id, joints)
    else:
        parents = sk.prim_mst(cost, root_id)
    return sk.rig_from_parents(joints, parents)
