"""Skeleton-connectivity data: the padded candidate-pair samples of RootNet
and BoneNet — counterpart of morig_tpu/data/skeleton_data.py (`pair_attrs`,
`build_skel_sample`, `capsule_skel_dataset`).

All joint pairs (i < j) with their [distance, inside fraction] attributes
(the fraction of the segment inside the voxel grid, one device call per
mesh; 1 without a grid), GT adjacency labels and the GT root when rigs are
given.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from morig_tpu_torch.core.batch import SkelSample, stack_meshes
from morig_tpu_torch.geometry import skeleton as sk
from morig_tpu_torch.geometry.voxel import segment_inside_fraction, vox_to_device
from morig_tpu_torch.nn.gcu import windowed_tile


def pair_attrs(joints: np.ndarray, vox=None, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """All (i<j) pairs (P, 2) int32 and their [dist, inside fraction]
    attributes (P, 2) f32, the fraction measured in `vox` on `device` (1
    without a grid)."""
    J = len(joints)
    pairs = np.array(list(itertools.combinations(range(J), 2)), np.int32).reshape(-1, 2)
    dist = np.linalg.norm(joints[pairs[:, 0]] - joints[pairs[:, 1]], axis=1)
    if vox is not None:
        starts = torch.as_tensor(joints[pairs[:, 0]], dtype=torch.float32, device=device)
        ends = torch.as_tensor(joints[pairs[:, 1]], dtype=torch.float32, device=device)
        frac = segment_inside_fraction(starts[None], ends[None],
                                       *vox_to_device([vox], device))[0].cpu().numpy()
    else:
        frac = np.ones(len(pairs))
    return pairs, np.stack([dist, frac], axis=1).astype(np.float32)


def build_skel_sample(mesh_entries: Sequence[dict], joints_list: Sequence[np.ndarray],
                      rigs: Optional[Sequence[sk.Rig]] = None, voxes: Optional[Sequence] = None,
                      max_joints: int = 48, device="cuda",
                      edge_tile: Optional[int] = None) -> SkelSample:
    """A padded SkelSample on `device` (the card unless the caller asks for
    another).  With `rigs`, labels come from GT adjacency and the GT root;
    otherwise they are zero (inference).  `edge_tile`: the mesh batch
    carries it where every table is local at it (`nn.gcu.windowed_tile`),
    so its edge layers run the windowed K5."""
    max_pairs = max_joints * (max_joints - 1) // 2
    Bn = len(mesh_entries)
    joints_a = np.zeros((Bn, max_joints, 3), np.float32)
    joints_m = np.zeros((Bn, max_joints), bool)
    pairs_a = np.zeros((Bn, max_pairs, 2), np.int64)
    pairs_m = np.zeros((Bn, max_pairs), bool)
    attr_a = np.zeros((Bn, max_pairs, 2), np.float32)
    label_a = np.zeros((Bn, max_pairs), np.float32)
    root_a = np.zeros((Bn,), np.int64)
    for i in range(Bn):
        j = np.asarray(joints_list[i], np.float32)
        J = min(len(j), max_joints)
        joints_a[i, :J] = j[:J]
        joints_m[i, :J] = True
        pr, at = pair_attrs(j[:J], voxes[i] if voxes is not None else None, device)
        n = min(len(pr), max_pairs)
        pairs_a[i, :n] = pr[:n]
        pairs_m[i, :n] = True
        attr_a[i, :n] = at[:n]
        if rigs is not None:
            adj = rigs[i].adjacency()
            label_a[i, :n] = adj[pr[:n, 0], pr[:n, 1]]
            root_a[i] = rigs[i].root_id

    def dev(x):
        return torch.as_tensor(x, device=device)

    return SkelSample(
        mesh=stack_meshes(list(mesh_entries), device,
                          edge_tile=windowed_tile(mesh_entries, edge_tile)),
        joints=dev(joints_a), joints_mask=dev(joints_m), pairs=dev(pairs_a),
        pair_mask=dev(pairs_m), pair_attr=dev(attr_a), pair_label=dev(label_a),
        root_idx=dev(root_a))


def capsule_skel_dataset(num_models: int = 2, max_joints: int = 16, device="cuda",
                         edge_tile: Optional[int] = None, **kw) -> SkelSample:
    """One SkelSample over synthetic capsules (`capsule_rig_dataset`'s meshes,
    GT joints and labels; `kw` goes to it), on `device`, stacked with
    `edge_tile` where its tables are local at it."""
    from morig_tpu_torch.data.rig import capsule_rig_dataset

    ds = capsule_rig_dataset(num_models=num_models, **kw)
    return build_skel_sample(ds._mesh_cache, [m.rig.pos for m in ds.models],
                             [m.rig for m in ds.models], max_joints=max_joints, device=device,
                             edge_tile=edge_tile)
