"""Voxel grids: binvox IO and solid voxelization (host), containment and
line of sight (device) — counterpart of morig_tpu/geometry/voxel.py.

`Voxels`, `read_binvox` / `write_binvox` (the .binvox format, byte for byte
the JAX package's), `voxelize_mesh` and `inside_check_np` are host copies (numpy;
the flood fill runs in the repository's C++ code through
`morig_tpu_torch.native`).  On the device
a grid travels as the triple (grid (B,D,D,D) bool, translate (B,3) fp32,
scale (B,) fp32), batched over meshes; containment is a direct
`grid[b, x, y, z]` lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from morig_tpu_torch import native


@dataclasses.dataclass
class Voxels:
    data: np.ndarray          # (D, D, D) bool, x-major
    translate: np.ndarray     # (3,)
    scale: float
    dims: int = 88


def read_binvox(path: str) -> Voxels:
    """A .binvox file (https://www.patrickmin.com/binvox/binvox.html): the
    header's dims, translate and scale, then run-length (value, count)
    byte pairs of the grid in x-z-y order."""
    with open(path, "rb") as f:
        if not f.readline().strip().startswith(b"#binvox"):
            raise ValueError(f"not a binvox file: {path}")
        dims = translate = scale = None
        while True:
            line = f.readline().strip().split()
            if not line:
                continue
            if line[0] == b"dim":
                dims = [int(x) for x in line[1:4]]
            elif line[0] == b"translate":
                translate = [float(x) for x in line[1:4]]
            elif line[0] == b"scale":
                scale = float(line[1])
            elif line[0] == b"data":
                break
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    flat = np.repeat(raw[::2].astype(bool), raw[1::2].astype(np.int64))
    data = np.transpose(flat.reshape(dims), (0, 2, 1))      # stored [x][z][y]
    return Voxels(data=np.ascontiguousarray(data), translate=np.asarray(translate, np.float64),
                  scale=scale, dims=dims[0])


def write_binvox(vox: Voxels, path: str) -> None:
    """Write `vox` as .binvox: runs of one value, each at most 255 long."""
    data = np.transpose(vox.data, (0, 2, 1)).reshape(-1).astype(np.uint8)
    starts = np.flatnonzero(np.r_[True, data[1:] != data[:-1]])
    lengths = np.diff(np.r_[starts, len(data)])
    chunks = (lengths + 254) // 255                         # runs split every 255
    values = np.repeat(data[starts], chunks)
    counts = np.full(len(values), 255, np.int64)
    counts[np.cumsum(chunks) - 1] = lengths - 255 * (chunks - 1)
    with open(path, "wb") as f:
        f.write(b"#binvox 1\n")
        f.write(f"dim {vox.dims} {vox.dims} {vox.dims}\n".encode())
        f.write(("translate " + " ".join(f"{t:g}" for t in vox.translate) + "\n").encode())
        f.write(f"scale {vox.scale:g}\n".encode())
        f.write(b"data\n")
        f.write(np.stack([values, counts], 1).astype(np.uint8).tobytes())


def voxelize_mesh(verts: np.ndarray, faces: np.ndarray, dims: int = 88,
                  pad: float = 0.02) -> Voxels:
    """Solid voxelization: rasterize the surface by dense barycentric face
    sampling (spacing at most half a cell, so the shell is watertight), then
    flood-fill the outside from the boundary; shell + interior = solid."""
    lo = verts.min(0) - pad
    hi = verts.max(0) + pad
    scale = float((hi - lo).max())
    translate = lo

    grid = np.zeros((dims, dims, dims), bool)
    cell = scale / dims
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    edge = np.maximum(
        np.linalg.norm(v1 - v0, axis=1),
        np.maximum(np.linalg.norm(v2 - v0, axis=1), np.linalg.norm(v2 - v1, axis=1)),
    )
    n_per_face = np.clip(np.ceil(edge / cell * 2.0).astype(int) + 1, 2, 64)
    pts = [verts]
    for n in np.unique(n_per_face):
        sel = n_per_face == n
        i, j = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
        keep = (i + j) <= n
        u = (i[keep] / n)[None, :, None]
        w = (j[keep] / n)[None, :, None]
        a, b, c = v0[sel][:, None], v1[sel][:, None], v2[sel][:, None]
        pts.append((a + u * (b - a) + w * (c - a)).reshape(-1, 3))
    pts = np.concatenate(pts, axis=0)
    idx = np.clip(np.round((pts - translate) / scale * dims).astype(int), 0, dims - 1)
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return Voxels(data=native.solid_fill(grid), translate=translate.astype(np.float64),
                  scale=scale, dims=dims)


def vox_to_device(voxes: Sequence[Voxels], device) -> tuple:
    """Stack grids of one `dims` into the device triple (grid (B,D,D,D)
    bool, translate (B,3) fp32, scale (B,) fp32)."""
    return (torch.as_tensor(np.stack([v.data for v in voxes]), dtype=torch.bool, device=device),
            torch.as_tensor(np.stack([np.asarray(v.translate, np.float32) for v in voxes]),
                            device=device),
            torch.as_tensor(np.asarray([v.scale for v in voxes], np.float32), device=device))


def inside_check_np(pts: np.ndarray, vox: Voxels) -> np.ndarray:
    """Host containment of (N, 3) points in one grid, in float64: the
    single-mesh joint stage's filter."""
    vc = np.round((pts - vox.translate) / vox.scale * vox.dims).astype(int)
    in_bounds = np.logical_and(np.all(vc >= 0, 1), np.all(vc < vox.dims, 1))
    vc = np.clip(vc, 0, vox.dims - 1)
    return np.logical_and(in_bounds, vox.data[vc[:, 0], vc[:, 1], vc[:, 2]])


def inside_check(pts: torch.Tensor, grid: torch.Tensor, translate: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """pts (B,...,3) -> bool (B,...): inside mesh b's grid.  Cell index
    round(((p - translate) / scale) * dims), halves to even, as the JAX
    package computes it; outside the grid is outside."""
    B, dims = grid.shape[0], grid.shape[1]
    lead = pts.shape[:-1]
    p = pts.reshape(B, -1, 3)
    vc = torch.round((p - translate[:, None, :]) / scale[:, None, None] * dims).to(torch.int64)
    in_bounds = ((vc >= 0) & (vc < dims)).all(-1)
    vc = vc.clamp(0, dims - 1)
    flat = ((torch.arange(B, device=pts.device)[:, None] * dims + vc[..., 0]) * dims
            + vc[..., 1]) * dims + vc[..., 2]
    return (in_bounds & grid.reshape(-1)[flat]).reshape(lead)


def sample_params(num_samples: int) -> torch.Tensor:
    """The JAX package's `jnp.linspace(0, 1, n)` in fp32, bit for bit: i times
    the fp32 reciprocal of n - 1, then exactly 1.  (`torch.linspace` differs
    from it in the last bit of some entries.)"""
    step = torch.tensor(1.0 / (num_samples - 1), dtype=torch.float32)
    t = torch.arange(num_samples - 1, dtype=torch.float32) * step
    return torch.cat([t, torch.ones(1)])


def segment_inside_fraction(starts: torch.Tensor, ends: torch.Tensor, grid: torch.Tensor,
                            translate: torch.Tensor, scale: torch.Tensor,
                            num_samples: int = 32) -> torch.Tensor:
    """starts, ends (B,...,3) -> (B,...) fp32: the share of num_samples evenly
    spaced points of each segment (both ends included) inside the grid."""
    t = sample_params(num_samples).to(starts.device)
    samples = starts[..., None, :] + t[:, None] * (ends - starts)[..., None, :]
    return inside_check(samples, grid, translate, scale).float().mean(-1)
