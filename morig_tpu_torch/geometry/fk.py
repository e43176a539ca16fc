"""Forward kinematics and linear blend skinning on the device —
counterpart of morig_tpu/geometry/fk.py, on tensors with any leading batch
shape.

The topology is fixed on the host: `FKTopology` holds one rig's
breadth-first levels, and `fk` composes level by level; `topology_arrays`
pads a rig into arrays, for `fk_masked` (level by level) and
`fk_masked_doubling` (pointer doubling, ceil(log2 depth) steps) over a
batch of rigs with different trees.  Every write is out of place
(`index_copy`, `torch.where`), so autograd runs through FK.  LBS is one
(V, J) @ (J, 12) product of the blended per-joint affines (`lbs_blend`).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


class FKTopology:
    """Static FK schedule of one rig: per level (child, parent) indices."""

    def __init__(self, parents: np.ndarray):
        parents = np.asarray(parents, int)
        self.parents = parents
        self.root = int(np.argwhere(parents < 0)[0, 0])
        self.num_joints = len(parents)
        levels: List[tuple] = []
        frontier = [self.root]
        while True:
            nxt = [j for j in range(self.num_joints) if parents[j] in frontier]
            if not nxt:
                break
            levels.append((np.asarray(nxt, np.int64), parents[nxt].astype(np.int64)))
            frontier = nxt
        self.levels = levels
        self._on: dict = {}

    def on(self, device) -> list:
        """[root index (1,), then (child, parent) per level] as index
        tensors on `device`, made once per device."""
        key = str(device)
        if key not in self._on:
            self._on[key] = [torch.tensor([self.root], device=device)] + [
                (torch.as_tensor(c, device=device), torch.as_tensor(p, device=device))
                for c, p in self.levels]
        return self._on[key]


def fk(topology: FKTopology, local_rots: torch.Tensor, offsets: torch.Tensor,
       root_trans: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """local_rots (..., J, 3, 3), offsets (..., J, 3) (the root's: its rest
    position), root_trans (..., 3) -> (G (..., J, 3, 3) global rotations,
    q (..., J, 3) joint positions)."""
    root, *levels = topology.on(local_rots.device)
    G = torch.zeros_like(local_rots).index_copy(-3, root, local_rots[..., root, :, :])
    root_q = offsets[..., root, :]
    if root_trans is not None:
        root_q = root_q + root_trans[..., None, :]
    q = torch.zeros_like(offsets).index_copy(-2, root, root_q)
    for child, parent in levels:
        Gp = G[..., parent, :, :]
        qc = q[..., parent, :] + torch.einsum("...lab,...lb->...la", Gp, offsets[..., child, :])
        G = G.index_copy(-3, child, Gp @ local_rots[..., child, :, :])
        q = q.index_copy(-2, child, qc)
    return G, q


def topology_arrays(parents: np.ndarray, max_joints: int):
    """Padded array form of a topology: (parents_p (Jmax,) with the root and
    the padded joints pointing at themselves, level_of (Jmax,) with the
    root at 0 and padded joints at -1, depth)."""
    parents = np.asarray(parents, int)
    J = len(parents)
    root = int(np.argwhere(parents < 0)[0, 0])
    level_of = np.full(max_joints, -1, np.int32)
    level_of[root] = 0
    frontier = [root]
    depth = 0
    while frontier:
        nxt = [j for j in range(J) if parents[j] in frontier]
        depth += 1
        for j in nxt:
            level_of[j] = depth
        frontier = nxt
    parents_p = np.arange(max_joints, dtype=np.int32)
    nonroot = np.argwhere(parents >= 0).reshape(-1)
    parents_p[nonroot] = parents[nonroot]
    return parents_p, level_of, depth


def _at_parents(x: torch.Tensor, parents: torch.Tensor, trailing: int) -> torch.Tensor:
    """x[..., parents[...], <trailing dims>] for batched parents (..., J)."""
    idx = parents.reshape(parents.shape + (1,) * trailing)
    return torch.take_along_dim(x, idx, dim=-1 - trailing)


def fk_masked(parents: torch.Tensor, level_of: torch.Tensor, local_rots: torch.Tensor,
              offsets: torch.Tensor, max_depth: int,
              root_trans: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """FK over array topologies (..., J) (`topology_arrays`), level by level
    up to `max_depth`.  Same as `fk` on the real joints; padded joints keep
    G = local_rots, q = offsets."""
    G, q = local_rots, offsets
    if root_trans is not None:
        q = q + torch.where((level_of == 0)[..., None], root_trans[..., None, :],
                            torch.zeros_like(q))
    for lvl in range(1, max_depth + 1):
        sel = level_of == lvl
        Gp = _at_parents(G, parents, 2)
        qc = _at_parents(q, parents, 1) + torch.einsum("...jab,...jb->...ja", Gp, offsets)
        G = torch.where(sel[..., None, None], Gp @ local_rots, G)
        q = torch.where(sel[..., None], qc, q)
    return G, q


def fk_masked_doubling(parents: torch.Tensor, level_of: torch.Tensor,
                       local_rots: torch.Tensor, offsets: torch.Tensor, max_depth: int,
                       root_trans: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """`fk_masked` by pointer doubling: each of ceil(log2(max_depth)) steps
    composes every joint's accumulated affine with its pointer ancestor's
    and squares the pointer; the root's affine (stripped to the identity
    during the scan) is applied once at the end.  Differs from `fk_masked`
    by float re-association only."""
    is_root = level_of == 0
    is_pad = level_of < 0
    strip = is_root | is_pad
    eye = torch.eye(3, dtype=local_rots.dtype, device=local_rots.device).expand_as(local_rots)
    R = torch.where(strip[..., None, None], eye, local_rots)
    t = torch.where(strip[..., None], torch.zeros_like(offsets), offsets)
    steps = 0 if max_depth <= 1 else int(np.ceil(np.log2(max_depth)))
    P = parents
    for _ in range(steps):
        Rp, tp = _at_parents(R, P, 2), _at_parents(t, P, 1)
        R = Rp @ R
        t = tp + torch.einsum("...jab,...jb->...ja", Rp, t)
        P = torch.take_along_dim(P, P, dim=-1)
    root_q = offsets
    if root_trans is not None:
        root_q = root_q + root_trans[..., None, :]
    root_R = torch.where(is_root[..., None, None], local_rots, torch.zeros_like(local_rots)).sum(-3)
    root_t = torch.where(is_root[..., None], root_q, torch.zeros_like(root_q)).sum(-2)
    G = root_R[..., None, :, :] @ R
    q = root_t[..., None, :] + torch.einsum("...ab,...jb->...ja", root_R, t)
    G = torch.where(is_pad[..., None, None], local_rots, G)
    q = torch.where(is_pad[..., None], offsets, q)
    return G, q


def lbs_from_local(G: torch.Tensor, q: torch.Tensor, vert_local: torch.Tensor,
                   skins: torch.Tensor) -> torch.Tensor:
    """out_v = sum_j w_vj (G_j x_jv + q_j); vert_local (..., J, V, 3),
    skins (..., V, J) -> (..., V, 3)."""
    moved = torch.einsum("...jab,...jvb->...jva", G, vert_local) + q[..., :, None, :]
    return torch.einsum("...vj,...jva->...va", skins, moved)


def blend_palette(G: torch.Tensor, q: torch.Tensor, ref_G: torch.Tensor,
                  ref_q: torch.Tensor) -> torch.Tensor:
    """Per-joint affines from the reference pose to the new one, (..., J,
    12) rows [A row-major | b]: A_j = G_j ref_G_j^T, b_j = q_j - A_j ref_q_j."""
    A = torch.einsum("...jab,...jcb->...jac", G, ref_G)
    b = q - torch.einsum("...jab,...jb->...ja", A, ref_q)
    return torch.cat([A.reshape(A.shape[:-2] + (9,)), b], -1)


def lbs_blend(G: torch.Tensor, q: torch.Tensor, ref_G: torch.Tensor, ref_q: torch.Tensor,
              ref_verts: torch.Tensor, skins: torch.Tensor) -> torch.Tensor:
    """LBS in matrix-palette form: skins (..., V, J) @ the (..., J, 12)
    palette, then one affine per vertex of ref_verts (..., V, 3)."""
    P = skins @ blend_palette(G, q, ref_G, ref_q)                  # (..., V, 12)
    M = P[..., :9].reshape(P.shape[:-1] + (3, 3))
    return torch.einsum("...vab,...vb->...va", M, ref_verts) + P[..., 9:]


def verts_to_local(G: torch.Tensor, q: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """World vertices (..., V, 3) in every joint's frame: x_jv = G_j^T (v - q_j)."""
    rel = verts[..., None, :, :] - q[..., :, None, :]              # (..., J, V, 3)
    return torch.einsum("...jba,...jvb->...jva", G, rel)


def lbs_rest(verts: torch.Tensor, joints: torch.Tensor, skins: torch.Tensor,
             G: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """LBS from the rest pose: v' = sum_j w_vj (G_j (v - p_j) + q_j)."""
    rel = verts[..., :, None, :] - joints[..., None, :, :]         # (..., V, J, 3)
    moved = torch.einsum("...jab,...vjb->...vja", G, rel) + q[..., None, :, :]
    return torch.einsum("...vj,...vja->...va", skins, moved)
