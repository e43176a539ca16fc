"""ctypes bindings for the repository's C++ preprocessing code
(native/morig_native.cpp) — counterpart of morig_tpu/native.py: the
voxelizer's flood fill, the surface-geodesic Dijkstra, the one-ring edge
extraction and the voxel BFS of the volumetric geodesic.

The library is built with g++ at first use into `build/morig_tpu_torch/`
at the repository root, named by a hash of the source (nothing is written
under native/).  This is host preprocessing outside the served call, and
it has no Python fallback: a host without g++ gets a RuntimeError.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
SRC = _REPO / "native" / "morig_native.cpp"
BUILD_DIR = _REPO / "build" / "morig_tpu_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The loaded library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            h = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
            out = BUILD_DIR / f"libmorig_native_{h[:16]}.so"
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.geodesic_knn_dijkstra.argtypes = [
                f32, f32, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, f32]
            i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.geodesic_knn_dijkstra.restype = None
            lib.solid_fill.argtypes = [u8, ctypes.c_int]
            lib.solid_fill.restype = None
            lib.one_ring_edges.argtypes = [i32, ctypes.c_int, i32, ctypes.c_int]
            lib.one_ring_edges.restype = ctypes.c_int
            lib.voxel_bfs.argtypes = [u8, ctypes.c_int, i32, ctypes.c_int, i32]
            lib.voxel_bfs.restype = None
            _lib = lib
    return _lib


def geodesic_all_pairs(pts: np.ndarray, normals: np.ndarray, knn: int = 5,
                       cos_min: float = -0.5, inf_offset: float = 8.0) -> np.ndarray:
    """(n, n) shortest paths over each point's knn nearest neighbours whose
    normals are not opposed (cos > cos_min); disconnected pairs get
    inf_offset + their euclidean distance."""
    pts = np.ascontiguousarray(pts, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    n = len(pts)
    out = np.zeros((n, n), np.float32)
    library().geodesic_knn_dijkstra(pts, normals, n, knn, cos_min, inf_offset, out)
    return out


def solid_fill(shell: np.ndarray) -> np.ndarray:
    """(d, d, d) surface shell -> solid occupancy (shell + interior)."""
    grid = np.ascontiguousarray(shell.astype(np.uint8))
    library().solid_fill(grid, grid.shape[0])
    return grid.astype(bool)


def one_ring_edges(faces: np.ndarray) -> np.ndarray:
    """(F, 3) triangles -> (E, 2) int32 unique edges (i < j), sorted."""
    faces = np.ascontiguousarray(faces, np.int32)
    cap = len(faces) * 3
    out = np.zeros((cap, 2), np.int32)
    n = library().one_ring_edges(faces, len(faces), out, cap)
    if n < 0:
        raise RuntimeError(f"one_ring_edges: more than {cap} edges")
    return out[:n].copy()


def voxel_bfs(solid: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """(d, d, d) occupancy and (S, 3) seed voxels -> (d, d, d) int32
    26-connected dilation steps from the nearest seed (0) through occupied
    voxels (-1 where unreachable; seeds outside the grid are skipped)."""
    grid = np.ascontiguousarray(solid.astype(np.uint8))
    seeds = np.ascontiguousarray(seeds, np.int32)
    d = grid.shape[0]
    out = np.zeros(d * d * d, np.int32)
    library().voxel_bfs(grid, d, seeds, len(seeds), out)
    return out.reshape(d, d, d)
