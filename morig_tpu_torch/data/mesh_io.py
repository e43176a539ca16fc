"""Mesh / point-cloud file IO: OBJ, PLY and edge lists — a copy of
morig_tpu/data/mesh_io.py (numpy only), so the port reads and writes the
same files byte for byte.

Replaces the reference's open3d mesh IO and utils/io_utils.py:18-58
(readPly/writePly/output_point_cloud_ply) without the open3d dependency.
Supports ASCII and binary-little-endian PLY with float/double vertex
properties — enough to round-trip the pipeline artifacts the reference
exchanges between stages (shifted-point .ply dumps, predicted rigs).
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def read_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def write_obj(path: str, verts: np.ndarray, faces: Optional[np.ndarray] = None) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        if faces is not None:
            for a, b, c in faces:
                f.write(f"f {a + 1} {b + 1} {c + 1}\n")


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "short": ("h", 2), "ushort": ("H", 2),
}


def read_ply_points(path: str) -> np.ndarray:
    """Read the vertex positions of an ASCII or binary_little_endian PLY."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        n_verts = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_verts = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] != "list":
                    props.append((parts[1], parts[2]))
            elif line == "end_header":
                break
        names = [p[1] for p in props]
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
        if fmt == "ascii":
            rows = []
            for _ in range(n_verts):
                vals = f.readline().split()
                rows.append([float(vals[ix]), float(vals[iy]), float(vals[iz])])
            return np.asarray(rows, np.float32)
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported ply format {fmt}")
        fmt_str = "<" + "".join(_PLY_TYPES[t][0] for t, _ in props)
        size = struct.calcsize(fmt_str)
        data = f.read(size * n_verts)
        out = np.zeros((n_verts, 3), np.float32)
        for i in range(n_verts):
            vals = struct.unpack_from(fmt_str, data, i * size)
            out[i] = (vals[ix], vals[iy], vals[iz])
        return out


def write_ply_points(path: str, pts: np.ndarray, binary: bool = True) -> None:
    """Write a point cloud as PLY (the reference dumps shifted points this
    way, io_utils.py:28-58 / train_rig.py:264)."""
    pts = np.asarray(pts, np.float32)
    header = [
        "ply",
        "format binary_little_endian 1.0" if binary else "format ascii 1.0",
        f"element vertex {len(pts)}",
        "property float x", "property float y", "property float z",
        "end_header",
    ]
    if binary:
        with open(path, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            f.write(pts.astype("<f4").tobytes())
    else:
        with open(path, "w") as f:
            f.write("\n".join(header) + "\n")
            for p in pts:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def load_edge_file(path: str) -> np.ndarray:
    """Load a *_tpl_e.txt / *_geo_e.txt edge list (rows of vertex pairs)."""
    e = np.loadtxt(path)
    if e.ndim == 1:
        e = e.reshape(1, -1)
    return e.astype(np.int64)
