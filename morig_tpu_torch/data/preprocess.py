"""Vertex reordering for neighbour locality (host, numpy/scipy) — the part of
morig_tpu/data/preprocess.py that makes an arbitrary mesh local enough for
the windowed edge kernel K5 (kernels/edge_fused.py
`check_neighbor_locality`)."""
from __future__ import annotations

import numpy as np


def rcm_vertex_order(num_verts: int, tpl_edges: np.ndarray,
                     geo_edges: np.ndarray) -> np.ndarray:
    """Bandwidth-reducing vertex order (reverse Cuthill-McKee) over the union
    of both edge sets: neighbour index distance is then bounded by the
    graph's bandwidth instead of V.  Returns `order` such that
    new_verts = verts[order]."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    e = np.concatenate([tpl_edges, geo_edges], axis=0).astype(np.int64)
    e = e[(e[:, 0] < num_verts) & (e[:, 1] < num_verts)]
    data = np.ones(len(e) * 2)
    rows = np.concatenate([e[:, 0], e[:, 1]])
    cols = np.concatenate([e[:, 1], e[:, 0]])
    A = coo_matrix((data, (rows, cols)), shape=(num_verts, num_verts)).tocsr()
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def apply_vertex_order(order: np.ndarray, verts: np.ndarray, tpl_edges: np.ndarray,
                       geo_edges: np.ndarray, *per_vertex_arrays: np.ndarray):
    """Permute a mesh (and any per-vertex arrays) into `order`; edge indices
    are remapped.  Returns (verts, tpl_edges, geo_edges, *arrays)."""
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    out_tpl = inv[tpl_edges.astype(np.int64)]
    out_geo = inv[geo_edges.astype(np.int64)]
    outs = tuple(a[order] for a in per_vertex_arrays)
    return (verts[order], out_tpl, out_geo) + outs
