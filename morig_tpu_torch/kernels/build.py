"""Build and load the package's CUDA kernels.

All sources under `morig_tpu_torch/csrc/` are compiled by `nvcc` for sm_90a,
one process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so the build takes seconds).  The library lands in
`build/morig_tpu_torch/` at the repository root, named by a hash of the
sources, and is built at first use: nothing is compiled when a module is
imported.  A host without `nvcc` gets a RuntimeError, never a substitute.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "morig_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported launcher; each returns cudaGetLastError().
_SIGNATURES = {
    # a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, H1, H2, stream
    "edge_mlp_table_forward": [_P] * 11 + [_I] * 5 + [_P],
    # the same, then the vertex tile TV, stream
    "edge_mlp_windowed_forward": [_P] * 11 + [_I] * 6 + [_P],
    # B, V, D, H1, H2, out grid, out splits
    "edge_mlp_backward_grid": [_I] * 5 + [ctypes.POINTER(_I)] * 2,
    # a, b, nbr, mask, w2, vecs, dout, da, db, dw2, vec, scratch, live, dw2_part,
    # vec_part, ymax, B, V, D, H1, H2, grid, splits, stream
    "edge_mlp_backward": [_P] * 16 + [_I] * 7 + [_P],
    # H, out splits
    "edge_mlp_dw2_grid": [_I, ctypes.POINTER(_I)],
    # scratch, live, dw2_part, dw2, n_steps, H, splits, stream
    "edge_mlp_dw2": [_P] * 4 + [_I] * 3 + [_P],
    # q, c, mask, values, idx, score, gathered, B, N, P, C, Cv, k, stream
    "knn_topk_gather": [_P] * 7 + [_I] * 6 + [_P],
    # q, c, mask, idx, score, B, N, P, C, k, stream
    "knn_topk": [_P] * 5 + [_I] * 5 + [_P],
    # values, idx, out, B, N, M, C, vec, stream
    "gather_rows_forward": [_P] * 3 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "morig_tpu_torch CUDA kernels cannot be built on this host")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmorig_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library for the current sources is absent.
    Returns its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    ptxas = ["-Xptxas=-v"] if verbose else []
    procs = [subprocess.Popen([nvcc, *ptxas, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [(p.communicate(), p.returncode) for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for (_, err), rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{err}")
        if verbose:
            print("".join(err for (_, err), _ in logs))
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream(device: torch.device) -> int:
    """The raw handle of the current stream of the CUDA `device`, on which the
    kernels launch.  Read without building a Stream object: the wrappers of
    the short kernels pay for every microsecond of host time."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
