"""Pose datasets: host-side numpy preprocessing into padded PoseSample
batches — counterpart of morig_tpu/data/pose.py.

A PoseModel holds the processed arrays of one animated model; PoseDataset
groups models into vertex-size buckets and emits dense padded PoseSample
batches for a chosen (src, tar) frame pair, on the device the caller asks
for (the card by default).  The random draws of the epoch schedule follow
the JAX package's generator call for call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from morig_tpu_torch.core import batch as B
from morig_tpu_torch.data.synthetic import make_capsule_sequence
from morig_tpu_torch.nn.gcu import windowed_tile

MAX_CORR = 1024    # correspondence rows per frame in a batch

@dataclasses.dataclass
class PoseModel:
    name: str
    vtx_traj: np.ndarray       # (V, T, 3)
    pts_traj: np.ndarray       # (P, T, 3)
    corr_v2p: np.ndarray       # (N, 3) [vertex, point, frame]
    corr_p2v: np.ndarray       # (N, 3) [point, vertex, frame]
    vismask: np.ndarray        # (V, T)
    tpl_edges: np.ndarray
    geo_edges: np.ndarray

    @property
    def num_verts(self):
        return self.vtx_traj.shape[0]

    @property
    def num_frames(self):
        return self.vtx_traj.shape[1]


def sample_frame_pair(rng: np.random.Generator, kind: str, sequential: bool,
                      num_frames: int) -> tuple[int, int]:
    """A training (src, tar) frame pair: for sequences, tar within a window
    of src; for discrete keyframes, src 0 (modelsresource) or any frame."""
    if sequential:
        window = 2 if kind == "modelsresource" else 3
        src = int(rng.integers(0, num_frames - 2))
        cands = [t for t in range(max(0, src - window), min(num_frames, src + window)) if t != src]
    else:
        if kind == "modelsresource":
            src = 0
            cands = list(range(1, num_frames))
        else:
            src = int(rng.integers(0, num_frames))
            cands = [t for t in range(num_frames) if t != src]
    tar = int(rng.choice(cands))
    return src, tar


def eval_frame_pair(sequential: bool) -> tuple[int, int]:
    """The deterministic evaluation pair."""
    return (10, 11) if sequential else (0, 3)


class PoseDataset:
    """Models grouped into vertex-size buckets: each model pads to the
    smallest bucket that fits it, and every batch is homogeneous in bucket.
    Each frame's correspondences are cut or padded to MAX_CORR rows.

    `edge_tile` (None: every batch on the full-table K1): a batch whose
    models' tables are all local at it (`nn.gcu.windowed_tile`) is stacked
    with it, so its edge layers run the windowed K5, in training too; any
    other batch stays on K1.  Nothing is reordered here
    (`data.preprocess.rcm_vertex_order` bounds how far a neighbour lies
    from its vertex, which may still exceed the tile)."""

    def __init__(
        self,
        models: Sequence[PoseModel],
        tpl_max_degree: int = 16,
        geo_max_degree: int = 16,
        buckets: Sequence[int] = (256, 512, 1024, 2048, 4096, 8192),
        edge_tile: Optional[int] = None,
    ):
        self.models = list(models)
        self.edge_tile = edge_tile
        self.bucket_of = [B.bucket_size(m.num_verts, buckets) for m in self.models]
        self._mesh_cache = [
            B.build_mesh(m.vtx_traj[:, 0, :], m.tpl_edges, m.geo_edges,
                         self.bucket_of[i], tpl_max_degree, geo_max_degree)
            for i, m in enumerate(self.models)
        ]

    def __len__(self):
        return len(self.models)

    def _corr_pad(self, corr: np.ndarray, frame: int):
        """The pairs of `frame`, cut or zero-padded to MAX_CORR rows."""
        rows = corr[corr[:, 2] == frame][:, :2].astype(np.int64)
        n = min(len(rows), MAX_CORR)
        out = np.zeros((MAX_CORR, 2), np.int64)
        mask = np.zeros(MAX_CORR, bool)
        out[:n] = rows[:n]
        mask[:n] = True
        return out, mask

    def batch(self, indices: Sequence[int], src: int, tar: int, device="cuda") -> B.PoseSample:
        """A padded PoseSample for models `indices` at (src, tar) on `device`.
        All models of one batch must share a bucket size."""
        pads = {self.bucket_of[i] for i in indices}
        if len(pads) != 1:
            raise ValueError(f"mixed buckets in one batch: {pads}")
        pad = pads.pop()
        meshes, ptss, ptms, v2ps, v2pms, p2vs, p2vms, viss, flows = ([] for _ in range(9))
        for i in indices:
            m = self.models[i]
            entry = dict(self._mesh_cache[i])
            entry["verts"] = B.pad_to(m.vtx_traj[:, src, :].astype(np.float32), pad)
            meshes.append(entry)
            ptss.append(m.pts_traj[:, tar, :].astype(np.float32))
            ptms.append(np.ones(len(m.pts_traj), bool))
            c, cm = self._corr_pad(m.corr_v2p, tar)
            v2ps.append(c)
            v2pms.append(cm)
            c, cm = self._corr_pad(m.corr_p2v, tar)
            p2vs.append(c)
            p2vms.append(cm)
            viss.append(B.pad_to(m.vismask[:, tar].astype(np.float32), pad))
            flow = (m.vtx_traj[:, tar, :] - m.vtx_traj[:, src, :]).astype(np.float32)
            flows.append(B.pad_to(flow, pad))

        def t(arrays):
            return torch.as_tensor(np.stack(arrays), device=device)

        return B.PoseSample(
            mesh=B.stack_meshes(meshes, device, edge_tile=windowed_tile(meshes, self.edge_tile)),
            points=B.PointBatch(t(ptss), t(ptms)),
            corr=B.CorrBatch(t(v2ps), t(v2pms), t(p2vs), t(p2vms)),
            vismask=t(viss),
            gt_flow=t(flows),
        )

    def epoch_schedule(self, rng: np.random.Generator, batch_size: int, kind: str,
                       sequential: bool, train: bool = True
                       ) -> list[tuple[list[int], int, int]]:
        """The (model indices, src, tar) schedule of one epoch: a permutation
        of the models (training), grouped by bucket into batches of
        batch_size (a ragged tail cycles the bucket's members in training and
        repeats its last one at eval), the batches shuffled, then one frame
        pair per batch."""
        order = rng.permutation(len(self.models)) if train else np.arange(len(self.models))
        nf = min(m.num_frames for m in self.models)

        by_bucket: dict[int, list[int]] = {}
        for i in order:
            by_bucket.setdefault(self.bucket_of[i], []).append(int(i))
        batch_ids: list[list[int]] = []
        for bucket in sorted(by_bucket):
            idxs = by_bucket[bucket]
            for s in range(0, len(idxs), batch_size):
                idx = idxs[s:s + batch_size]
                if len(idx) < batch_size:
                    if train:
                        while len(idx) < batch_size:
                            idx = idx + idxs[:batch_size - len(idx)]
                    else:
                        idx = idx + [idx[-1]] * (batch_size - len(idx))
                batch_ids.append(idx)
        if train and len(batch_ids) > 1:
            batch_ids = [batch_ids[k] for k in rng.permutation(len(batch_ids))]

        sched = []
        for idx in batch_ids:
            if train:
                src, tar = sample_frame_pair(rng, kind, sequential, nf)
            else:
                src, tar = eval_frame_pair(sequential)
                src, tar = min(src, nf - 2), min(tar, nf - 1)
            sched.append((idx, src, tar))
        return sched

    def epoch_batches(self, rng: np.random.Generator, batch_size: int, kind: str,
                      sequential: bool, train: bool = True, device="cuda"):
        """Yield the PoseSample batches of one epoch (`epoch_schedule`)."""
        for idx, src, tar in self.epoch_schedule(rng, batch_size, kind, sequential, train):
            yield self.batch(idx, src, tar, device)


def capsule_pose_dataset(num_models: int = 2, seed: int = 0, **kw) -> PoseDataset:
    """A PoseDataset of synthetic capsules (data/synthetic.py), capsule i
    from seed `seed + i`; `kw` goes to `make_capsule_sequence`."""
    models = []
    for i in range(num_models):
        seq = make_capsule_sequence(seed=seed + i, **kw)
        models.append(PoseModel(
            name=f"capsule{i}", vtx_traj=seq["vtx_traj"], pts_traj=seq["pts_traj"],
            corr_v2p=seq["corr_v2p"], corr_p2v=seq["corr_p2v"], vismask=seq["vismask"],
            tpl_edges=seq["tpl_edges"], geo_edges=seq["geo_edges"]))
    return PoseDataset(models)
