"""Skeleton structure and the host algorithms of rig assembly (numpy) —
counterpart of morig_tpu/geometry/skeleton.py: `get_bones`, `map_bones`,
`prim_mst`, `prim_mst_symmetry` (with `side_of` and `mirror_map`),
`prim_mst_middle_first`, `increase_cost_for_outside_bone`,
`rig_from_parents`, `assemble_skel_skin` and `remove_duplicate_joints`,
with the `Rig` structure they share (offsets, adjacency, numpy forward
kinematics, and the *_rig.txt format of `save` / `load`:
`joints <name> <x> <y> <z>`, `root <name>`, `skin <vid> (<joint> <w>)*`,
`hier <parent> <child>`), and the *_skel.txt level format
(`save_skel_format` / `load_skel_format`: `<level> <name> <x> <y> <z>
<parent or None>`).

These work on graphs of at most ~50 joints and stay on the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Rig:
    names: List[str]
    pos: np.ndarray                       # (J, 3)
    parents: np.ndarray                   # (J,) int, -1 for root
    skins: Optional[np.ndarray] = None    # (V, J) or None

    @property
    def num_joints(self) -> int:
        return len(self.names)

    @property
    def root_id(self) -> int:
        return int(np.argwhere(self.parents < 0)[0, 0])

    def children(self, j: int) -> np.ndarray:
        return np.argwhere(self.parents == j).reshape(-1)

    def levels(self) -> List[np.ndarray]:
        """Topological levels, root first."""
        out = [np.array([self.root_id])]
        while True:
            nxt = (np.concatenate([self.children(int(j)) for j in out[-1]])
                   if len(out[-1]) else np.array([], int))
            if len(nxt) == 0:
                return out
            out.append(nxt)

    def offsets(self) -> np.ndarray:
        """Rest offsets from each joint's parent (the root: its position)."""
        off = self.pos.copy()
        nonroot = self.parents >= 0
        off[nonroot] = self.pos[nonroot] - self.pos[self.parents[nonroot]]
        return off

    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.num_joints, self.num_joints))
        nonroot = np.argwhere(self.parents >= 0).reshape(-1)
        A[nonroot, self.parents[nonroot]] = 1.0
        return np.maximum(A, A.T)

    def fk(self, local_rots: np.ndarray, root_trans: Optional[np.ndarray] = None):
        """(global rotations (J,3,3), joint positions (J,3)) from per-joint
        local rotations (J,3,3), the rest frames being the identity."""
        G = np.zeros((self.num_joints, 3, 3), local_rots.dtype)
        q = np.zeros((self.num_joints, 3), np.float64)
        off = self.offsets()
        for level in self.levels():
            for j in level:
                p = self.parents[j]
                if p < 0:
                    G[j] = local_rots[j]
                    q[j] = self.pos[j] + (root_trans if root_trans is not None else 0.0)
                else:
                    G[j] = G[p] @ local_rots[j]
                    q[j] = q[p] + G[p] @ off[j]
        return G, q

    def global_transforms_homogeneous(self, local_rots=None, root_trans=None) -> np.ndarray:
        """(J,4,4) homogeneous global transforms of `fk`: rotation block and
        joint position; the rest pose (identity local rotations) by default."""
        if local_rots is None:
            local_rots = np.repeat(np.eye(3)[None], self.num_joints, 0)
        G, q = self.fk(local_rots, root_trans)
        out = np.repeat(np.eye(4)[None], self.num_joints, 0)
        out[:, :3, :3] = G
        out[:, :3, 3] = q
        return out

    def save(self, path: str) -> None:
        root = self.root_id
        with open(path, "w") as f:
            for name, p in zip(self.names, self.pos):
                f.write(f"joints {name} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n")
            f.write(f"root {self.names[root]}\n")
            if self.skins is not None:
                for vid, row in enumerate(self.skins):
                    active = np.argwhere(row > 0).reshape(-1)
                    entries = " ".join(f"{self.names[j]} {row[j]:.4f}" for j in active)
                    f.write(f"skin {vid} {entries}\n".rstrip() + "\n")
            for level in self.levels():
                for j in level:
                    for c in self.children(int(j)):
                        f.write(f"hier {self.names[j]} {self.names[c]}\n")

    @classmethod
    def load(cls, path: str) -> "Rig":
        names: List[str] = []
        pos: List[np.ndarray] = []
        skin_rows: List[tuple] = []
        hier: List[tuple] = []
        with open(path) as f:
            for line in f:
                w = line.split()
                if not w:
                    continue
                if w[0] == "joints":
                    names.append(w[1])
                    pos.append(np.array([float(w[2]), float(w[3]), float(w[4])]))
                elif w[0] == "skin":
                    skin_rows.append((int(w[1]), w[2:]))
                elif w[0] == "hier":
                    hier.append((w[1], w[2]))
        idx = {n: i for i, n in enumerate(names)}
        parents = np.full(len(names), -1, int)
        for p, c in hier:
            parents[idx[c]] = idx[p]
        skins = None
        if skin_rows:
            nv = max(v for v, _ in skin_rows) + 1
            skins = np.zeros((nv, len(names)))
            for vid, items in skin_rows:
                for i in range(0, len(items), 2):
                    skins[vid, idx[items[i]]] = float(items[i + 1])
        return cls(names=names, pos=np.stack(pos), parents=parents, skins=skins)


def rig_from_parents(joints: np.ndarray, parents: np.ndarray,
                     names: Optional[Sequence[str]] = None) -> Rig:
    names = list(names) if names is not None else [f"joint_{i}" for i in range(len(joints))]
    return Rig(names=names, pos=np.asarray(joints, float), parents=np.asarray(parents, int))


def get_bones(rig: Rig):
    """Bones in breadth-first order, with a zero-length leaf bone appended at
    each childless joint (one leaf bone at the root of a single-joint rig).
    Returns (bones (B,6), names [(parent, child)], isleaf (B,))."""
    bones, names, isleaf = [], [], []
    for level in rig.levels():
        for j in level:
            for c in rig.children(int(j)):
                bones.append(np.concatenate([rig.pos[j], rig.pos[c]]))
                names.append((rig.names[j], rig.names[c]))
                isleaf.append(False)
                if len(rig.children(int(c))) == 0:
                    bones.append(np.concatenate([rig.pos[c], rig.pos[c]]))
                    names.append((rig.names[c], rig.names[c] + "_leaf"))
                    isleaf.append(True)
    if not bones:
        r = rig.root_id
        bones.append(np.concatenate([rig.pos[r], rig.pos[r]]))
        names.append((rig.names[r], rig.names[r] + "_leaf"))
        isleaf.append(True)
    return np.stack(bones), names, np.asarray(isleaf)


def add_duplicate_joints(rig: Rig) -> Rig:
    """Split branch points: each child of a multi-child joint gets its own
    copy of the parent, moved 1% along the bone, so every chain is unary.
    Skins are not carried."""
    names = [rig.names[rig.root_id]]
    pos = [rig.pos[rig.root_id]]
    parents = [-1]
    index = {rig.names[rig.root_id]: 0}
    for level in rig.levels():
        for j in level:
            ch = rig.children(int(j))
            if len(ch) > 1:
                for d, c in enumerate(ch):
                    dup = f"{rig.names[j]}_dup_{d}"
                    pos.append(rig.pos[j] + 0.01 * (rig.pos[c] - rig.pos[j]))
                    names.append(dup)
                    parents.append(index[rig.names[j]])
                    index[dup] = len(names) - 1
                    pos.append(rig.pos[c])
                    names.append(rig.names[c])
                    parents.append(index[dup])
                    index[rig.names[c]] = len(names) - 1
            elif len(ch) == 1:
                c = ch[0]
                pos.append(rig.pos[c])
                names.append(rig.names[c])
                parents.append(index[rig.names[j]])
                index[rig.names[c]] = len(names) - 1
    return Rig(names=names, pos=np.stack(pos), parents=np.asarray(parents, int))


def remove_duplicate_joints(rig: Rig) -> Rig:
    """Inverse of add_duplicate_joints: collapse the "_dup" joints, folding
    their skin columns into the parent."""
    assert rig.skins is not None
    keep_names = [rig.names[rig.root_id]]
    keep_pos = [rig.pos[rig.root_id]]
    keep_parents = [-1]
    keep_skin = [rig.skins[:, rig.root_id].copy()]
    index = {rig.names[rig.root_id]: 0}
    stack = [rig.root_id]
    while stack:
        j = stack.pop(0)
        for c in rig.children(int(j)):
            if "_dup" in rig.names[c]:
                keep_skin[index[rig.names[j]]] += rig.skins[:, c]
                for gc in rig.children(int(c)):
                    keep_names.append(rig.names[gc])
                    keep_pos.append(rig.pos[gc])
                    keep_parents.append(index[rig.names[j]])
                    keep_skin.append(rig.skins[:, gc].copy())
                    index[rig.names[gc]] = len(keep_names) - 1
                    stack.append(int(gc))
            else:
                keep_names.append(rig.names[c])
                keep_pos.append(rig.pos[c])
                keep_parents.append(index[rig.names[j]])
                keep_skin.append(rig.skins[:, c].copy())
                index[rig.names[c]] = len(keep_names) - 1
                stack.append(int(c))
    return Rig(names=keep_names, pos=np.stack(keep_pos),
               parents=np.asarray(keep_parents, int), skins=np.stack(keep_skin, axis=1))


def map_bones(bones_old: np.ndarray, bones_new: np.ndarray) -> np.ndarray:
    """For each old bone (6 floats), the index of the nearest new bone."""
    d = np.linalg.norm(bones_new[None] - bones_old[:, None], axis=-1)
    return d.argmin(1)


def assemble_skel_skin(skel: Rig, attachment: np.ndarray) -> Rig:
    """Attach per-bone skin weights (V, bones of `skel`) to the rig with
    duplicated branch joints: each bone's weight binds to its parent joint."""
    bones_old, _, _ = get_bones(skel)
    rig_new = add_duplicate_joints(skel)
    bones_new, names_new, _ = get_bones(rig_new)
    mapping = map_bones(bones_old, bones_new)
    idx = {n: i for i, n in enumerate(rig_new.names)}
    skins = np.zeros((attachment.shape[0], rig_new.num_joints))
    for b in range(attachment.shape[1]):
        bind = idx[names_new[mapping[b]][0]]
        skins[:, bind] += np.where(attachment[:, b] > 1e-5, attachment[:, b], 0.0)
    rig_new.skins = skins
    return rig_new


def prim_mst(cost: np.ndarray, root: int) -> np.ndarray:
    """Dense-graph Prim MST; returns the parent array with -1 at the root."""
    n = cost.shape[0]
    key = np.full(n, np.inf)
    parent = np.full(n, -1, int)
    in_tree = np.zeros(n, bool)
    key[root] = 0.0
    for _ in range(n):
        u = int(np.argmin(np.where(in_tree, np.inf, key)))
        in_tree[u] = True
        upd = (~in_tree) & (cost[u] > 0) & (cost[u] < key)
        key[upd] = cost[u][upd]
        parent[upd] = u
    parent[root] = -1
    return parent


def side_of(joints: np.ndarray, tol: float = 2e-2) -> np.ndarray:
    """-1 left / 0 middle / +1 right of the x=0 symmetry plane."""
    s = np.zeros(len(joints), int)
    s[joints[:, 0] < -tol] = -1
    s[joints[:, 0] > tol] = 1
    return s


def mirror_map(joints: np.ndarray, tol: float = 2e-2, match_tol: float = 1e-3) -> dict:
    """Map left<->right joints whose mirror images coincide."""
    s = side_of(joints, tol)
    mapping = {}
    mirrored = joints * np.array([[-1.0, 1.0, 1.0]])
    for i in np.argwhere(s != 0).reshape(-1):
        opp = np.argwhere(s == -s[i]).reshape(-1)
        if len(opp) == 0:
            continue
        d = np.linalg.norm(joints[opp] - mirrored[i], axis=1)
        k = int(np.argmin(d))
        if d[k] < match_tol:
            mapping[int(i)] = int(opp[k])
    return mapping


def prim_mst_symmetry(cost: np.ndarray, root: int, joints: np.ndarray,
                      tol: float = 2e-2) -> tuple[np.ndarray, int]:
    """Symmetry-aware Prim: when a side joint with a mirror twin is attached,
    its twin is attached in the same step to the mirrored parent; the root
    is snapped to the nearest middle joint.  Returns (parents, root)."""
    n = cost.shape[0]
    s = side_of(joints, tol)
    twins = mirror_map(joints, tol)
    mids = np.argwhere(s == 0).reshape(-1)
    if s[root] != 0 and len(mids) > 0:
        root = int(mids[np.argmin(np.linalg.norm(joints[mids] - joints[root], axis=1))])

    key = np.full(n, np.inf)
    parent = np.full(n, -1, int)
    in_tree = np.zeros(n, bool)
    key[root] = 0.0

    def relax(u):
        upd = (~in_tree) & (cost[u] > 0) & (cost[u] < key)
        key[upd] = cost[u][upd]
        parent[upd] = u

    while not in_tree.all():
        u = int(np.argmin(np.where(in_tree, np.inf, key)))
        in_tree[u] = True
        relax(u)
        if s[u] != 0 and u in twins:
            u2 = twins[u]
            p = parent[u]
            if not in_tree[u2] and p >= 0:
                # mirrored parent: twin of p if sided, p itself if middle
                p2 = twins.get(int(p), int(p)) if s[p] != 0 else int(p)
                in_tree[u2] = True
                parent[u2] = p2
                key[u2] = cost[u2, p2]
                relax(u2)
    parent[root] = -1
    return parent, root


def increase_cost_for_outside_bone(cost: np.ndarray, joints: np.ndarray,
                                   inside_frac_fn=None, tol: float = 2e-2,
                                   frac: Optional[np.ndarray] = None) -> np.ndarray:
    """Penalize candidate bones leaving the volume; halve cost between
    middle-plane joints.  `inside_frac_fn(starts, ends)` returns the
    in-volume sample fraction per segment; alternatively pass precomputed
    `frac` per upper-triangle pair (row-major, the combinations/triu order)."""
    J = len(joints)
    ii, jj = np.triu_indices(J, k=1)
    starts, ends = joints[ii], joints[jj]
    if frac is None:
        frac = np.asarray(inside_frac_fn(starts, ends))
    else:
        frac = np.asarray(frac)[: len(ii)]
    seg_len = np.linalg.norm(ends - starts, axis=1)
    num_samples = np.maximum(np.round(seg_len / 0.01), 1)
    outside = (1.0 - frac) * num_samples
    cost = cost.copy()
    bad = outside > 1
    cost[ii[bad], jj[bad]] = 2.0 * outside[bad]
    cost[jj[bad], ii[bad]] = 2.0 * outside[bad]
    mid = np.abs(joints[:, 0]) < tol
    both_mid = mid[ii] & mid[jj]
    cost[ii[both_mid], jj[both_mid]] *= 0.5
    cost[jj[both_mid], ii[both_mid]] *= 0.5
    return cost


def prim_mst_middle_first(cost: np.ndarray, root: int, joints: np.ndarray,
                          tol: float = 2e-2) -> tuple[np.ndarray, int]:
    """Prim that spans every middle-plane joint before attaching a side
    joint; the root is snapped to the nearest middle joint.  Returns
    (parents, root)."""
    n = cost.shape[0]
    s = side_of(joints, tol)
    mids = np.argwhere(s == 0).reshape(-1)
    if s[root] != 0 and len(mids) > 0:
        root = int(mids[np.argmin(np.linalg.norm(joints[mids] - joints[root], axis=1))])
    key = np.full(n, np.inf)
    parent = np.full(n, -1, int)
    in_tree = np.zeros(n, bool)
    key[root] = 0.0

    def attach(u):
        in_tree[u] = True
        upd = (~in_tree) & (cost[u] > 0) & (cost[u] < key)
        key[upd] = cost[u][upd]
        parent[upd] = u

    while len(mids) and not in_tree[mids].all():
        attach(int(mids[np.argmin(np.where(in_tree[mids], np.inf, key[mids]))]))
    while not in_tree.all():
        attach(int(np.argmin(np.where(in_tree, np.inf, key))))
    parent[root] = -1
    return parent, root


def save_skel_format(rig: Rig, path: str) -> None:
    """Write `rig` as *_skel.txt: one `<level> <name> <x> <y> <z> <parent>`
    line per joint, level by level from the root (level 1, parent None)."""
    with open(path, "w") as f:
        for depth, level in enumerate(rig.levels(), start=1):
            for j in level:
                parent = rig.parents[j]
                pname = rig.names[parent] if parent >= 0 else "None"
                p = rig.pos[j]
                f.write(f"{depth} {rig.names[j]} {p[0]:8f} {p[1]:8f} {p[2]:8f} {pname}\n")


def load_skel_format(path: str) -> Rig:
    """Read a *_skel.txt file (lines of fewer than 6 words are skipped)."""
    names, pos, parent_names = [], [], []
    with open(path) as f:
        for line in f:
            w = line.split()
            if len(w) < 6:
                continue
            names.append(w[1])
            pos.append([float(w[2]), float(w[3]), float(w[4])])
            parent_names.append(w[5])
    idx = {n: i for i, n in enumerate(names)}
    parents = np.array([idx.get(p, -1) if p != "None" else -1 for p in parent_names], int)
    return Rig(names=names, pos=np.asarray(pos, float), parents=parents)
