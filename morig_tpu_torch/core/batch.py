"""Padded-batch data structures (counterpart of morig_tpu/core/batch.py).

Meshes and point clouds are dense padded tensors with validity masks; edges
are fixed-width neighbor tables whose slot 0 is the self loop and whose
invalid slots point at their own row, so every gather stays in bounds.
Index tensors are int64 (torch's index type) where the JAX package's are
int32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from morig_tpu_torch.kernels.gather_fused import reverse_table

_TENSORS = ("verts", "vert_mask", "tpl_nbr", "tpl_mask", "geo_nbr", "geo_mask")


@dataclasses.dataclass(frozen=True)
class MeshBatch:
    """verts (B,V,3) f32, vert_mask (B,V) bool, tpl_nbr/geo_nbr (B,V,D)
    int64, tpl_mask/geo_mask (B,V,D) bool.  `edge_tile`: the vertex tile of
    the windowed edge kernel K5 when every table is local at it
    (nn/gcu.py `auto_select_edge_impl`), None for the full-table K1.
    `tpl_rev`/`geo_rev`: each table's reverse table, the order in which the
    edge backward K6 sums its db_table, built on the tables' device on first
    use and then held for the batch (its tensors are not changed in place;
    `to` and `repeat_interleave` give a new batch that builds its own)."""

    verts: torch.Tensor
    vert_mask: torch.Tensor
    tpl_nbr: torch.Tensor
    tpl_mask: torch.Tensor
    geo_nbr: torch.Tensor
    geo_mask: torch.Tensor
    edge_tile: Optional[int] = None

    @functools.cached_property
    def tpl_rev(self) -> tuple[torch.Tensor, torch.Tensor]:
        return reverse_table(self.tpl_nbr, self.tpl_nbr.shape[1], self.tpl_mask)

    @functools.cached_property
    def geo_rev(self) -> tuple[torch.Tensor, torch.Tensor]:
        return reverse_table(self.geo_nbr, self.geo_nbr.shape[1], self.geo_mask)

    def to(self, device) -> "MeshBatch":
        return dataclasses.replace(self, **{k: getattr(self, k).to(device) for k in _TENSORS})

    def repeat_interleave(self, n: int) -> "MeshBatch":
        """Each entry repeated n times consecutively (the B*T keyframe axis)."""
        return dataclasses.replace(self, **{k: getattr(self, k).repeat_interleave(n, dim=0)
                                            for k in _TENSORS})


@dataclasses.dataclass(frozen=True)
class PointBatch:
    """pts (B,P,3) f32, pts_mask (B,P) bool."""

    pts: torch.Tensor
    pts_mask: torch.Tensor

    def to(self, device) -> "PointBatch":
        return PointBatch(self.pts.to(device), self.pts_mask.to(device))


@dataclasses.dataclass(frozen=True)
class CorrBatch:
    """Padded correspondence pairs of one (src, tar) frame pair: v2p / p2v
    (B,N,2) int64 (anchor index, positive index), *_mask (B,N) bool."""

    v2p: torch.Tensor
    v2p_mask: torch.Tensor
    p2v: torch.Tensor
    p2v_mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PoseSample:
    """One batch of the pose datasets: mesh (source frame), point cloud
    (target frame), correspondences, vismask (B,V) f32 (GT visibility of
    each vertex) and gt_flow (B,V,3) f32 (vtx_tar - vtx_src)."""

    mesh: MeshBatch
    points: PointBatch
    corr: CorrBatch
    vismask: torch.Tensor
    gt_flow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SkelSample:
    """Skeleton-connectivity input of RootNet and BoneNet: joints (B,J,3)
    f32, joints_mask (B,J) bool, candidate pairs (B,P,2) int64 with
    pair_mask (B,P) bool, pair_attr (B,P,2) f32 [distance, inside
    fraction], pair_label (B,P) f32 adjacency and root_idx (B,) int64 (both
    zero at inference)."""

    mesh: MeshBatch
    joints: torch.Tensor
    joints_mask: torch.Tensor
    pairs: torch.Tensor
    pair_mask: torch.Tensor
    pair_attr: torch.Tensor
    pair_label: torch.Tensor
    root_idx: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RigSample:
    """One batch of the rig and skin datasets: joints (B,J,3) f32 and
    joints_mask (B,J) bool; per vertex offsets (B,V,3) to the nearest joint,
    attn_mask (B,V) f32 (GT attention), gt_skin (B,V,J) f32 (the padded skin
    matrix), gt_flow and pred_flow (B,V,3T) f32 (the keyframe flows, GT and
    the deform stage's), and over the K nearest bones skin_input (B,V,8K) f32
    descriptors, skin_label (B,V,K) f32 soft labels, skin_nn (B,V,K) int64
    bone ids and loss_mask (B,V,K) int32 slot validity."""

    mesh: MeshBatch
    joints: torch.Tensor
    joints_mask: torch.Tensor
    offsets: torch.Tensor
    attn_mask: torch.Tensor
    gt_skin: torch.Tensor
    gt_flow: torch.Tensor
    pred_flow: torch.Tensor
    skin_input: torch.Tensor
    skin_label: torch.Tensor
    skin_nn: torch.Tensor
    loss_mask: torch.Tensor

    def to(self, device) -> "RigSample":
        return RigSample(self.mesh.to(device), *(getattr(self, f.name).to(device)
                                                 for f in dataclasses.fields(self)[1:]))


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the last bucket if none fits)."""
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


def pad_to(arr: np.ndarray, n: int, axis: int = 0, value=0.0) -> np.ndarray:
    """Pad `arr` with `value` along `axis` up to length n (cut to n when
    longer)."""
    cur = arr.shape[axis]
    if cur >= n:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, n)
        return arr[tuple(sl)]
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, n - cur)
    return np.pad(arr, widths, constant_values=value)


def edges_to_neighbor_table(edges: np.ndarray, num_verts: int, max_degree: int,
                            pad_to: int) -> tuple[np.ndarray, np.ndarray]:
    """(E,2) undirected edge list -> (pad_to, max_degree) table + mask.

    Slot 0 is the self loop; invalid slots point at the row's own vertex;
    overflow neighbors beyond max_degree are dropped in sorted-pair order
    (morig_tpu/core/batch.py:159)."""
    nbr = np.tile(np.arange(pad_to, dtype=np.int32)[:, None], (1, max_degree))
    mask = np.zeros((pad_to, max_degree), dtype=bool)
    mask[:num_verts, 0] = True
    fill = np.ones(pad_to, dtype=np.int32)
    if edges.size:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        both = np.concatenate([edges, edges[:, ::-1]], axis=0)
        both = np.unique(both[both[:, 0] != both[:, 1]], axis=0)
        for a, b in both:
            if a < num_verts and b < num_verts and fill[a] < max_degree:
                nbr[a, fill[a]] = b
                mask[a, fill[a]] = True
                fill[a] += 1
    return nbr, mask


def build_mesh(verts: np.ndarray, tpl_edges: np.ndarray, geo_edges: np.ndarray,
               pad_verts: int, tpl_max_degree: int = 16,
               geo_max_degree: int = 16) -> dict[str, np.ndarray]:
    """Arrays of one unbatched mesh entry, padded to pad_verts rows."""
    v = np.asarray(verts, dtype=np.float32)
    nv = len(v)
    if nv > pad_verts:
        raise ValueError(f"{nv} vertices do not fit pad_verts={pad_verts}")
    tpl_nbr, tpl_mask = edges_to_neighbor_table(tpl_edges, nv, tpl_max_degree, pad_verts)
    geo_nbr, geo_mask = edges_to_neighbor_table(geo_edges, nv, geo_max_degree, pad_verts)
    vert_mask = np.zeros(pad_verts, dtype=bool)
    vert_mask[:nv] = True
    return dict(
        verts=np.pad(v, ((0, pad_verts - nv), (0, 0))),
        vert_mask=vert_mask,
        tpl_nbr=tpl_nbr, tpl_mask=tpl_mask,
        geo_nbr=geo_nbr, geo_mask=geo_mask,
    )


def stack_meshes(entries: Sequence[dict], device="cuda",
                 edge_tile: Optional[int] = None) -> MeshBatch:
    """Stack per-mesh dicts (all padded to the same V) into a MeshBatch on
    `device` (the card unless the caller asks for another)."""
    def stack(k, dtype):
        return torch.as_tensor(np.stack([e[k] for e in entries]), dtype=dtype,
                               device=device)

    return MeshBatch(
        verts=stack("verts", torch.float32),
        vert_mask=stack("vert_mask", torch.bool),
        tpl_nbr=stack("tpl_nbr", torch.int64),
        tpl_mask=stack("tpl_mask", torch.bool),
        geo_nbr=stack("geo_nbr", torch.int64),
        geo_mask=stack("geo_mask", torch.bool),
        edge_tile=edge_tile,
    )
