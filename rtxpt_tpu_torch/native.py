"""Host-side native code of the port: the binned-SAH BVH2 builder
(``csrc/bvh_builder.cpp``), bound with ctypes.

The library is compiled with g++ on first use into
``rtxpt_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source
and the flags, so a fresh checkout builds it itself. There is no Python
fallback: a missing compiler or a failed build raises, since another
builder would silently give another tree.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# no -march=native and no FMA contraction: the SAH costs round the same on
# every host, so every machine builds the same tree
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_lib = None


def build() -> Path:
    """Compile the builder (once per source and flags); returns the .so."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libbvh_builder_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the BVH builder "
                           "(csrc/bvh_builder.cpp) is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / so.name
        out = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o",
                              str(tmp_so)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        if out.returncode != 0:
            raise RuntimeError("g++ failed on bvh_builder.cpp:\n"
                               + out.stdout.decode(errors="replace"))
        os.replace(tmp_so, so)
    return so


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        handle.bvh_build.restype = ctypes.c_int64
        handle.bvh_build.argtypes = [fp, ctypes.c_int64, ip, ctypes.c_int64,
                                     ctypes.c_int32]
        handle.bvh_get_nodes.argtypes = [fp, ip, ip]
        handle.bvh_get_nodes.restype = None
        handle.bvh_get_order.argtypes = [ctypes.POINTER(ctypes.c_int64)]
        handle.bvh_get_order.restype = None
        handle.bvh_free.argtypes = []
        handle.bvh_free.restype = None
        _lib = handle
    return _lib


def build_bvh_native(positions: np.ndarray, indices: np.ndarray,
                     leaf_size: int):
    """Binned-SAH BVH2 of T >= 1 triangles -> (bounds (N,12) f32,
    child (N,2) i32, depth (N,) i32, order (T,) i64)."""
    handle = lib()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    t = indices.shape[0]
    if positions.ndim != 2 or positions.shape[1] != 3 or indices.ndim != 2 \
            or indices.shape[1] != 3 or t == 0 \
            or indices.min() < 0 or indices.max() >= positions.shape[0]:
        raise ValueError(f"bvh_build: positions {positions.shape}, "
                         f"indices {indices.shape} out of range")
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    n_nodes = handle.bvh_build(positions.ctypes.data_as(fp),
                               positions.shape[0],
                               indices.ctypes.data_as(ip), t, leaf_size)
    if n_nodes <= 0:
        raise RuntimeError(f"bvh_build failed on {t} triangles")
    bounds = np.empty((n_nodes, 12), np.float32)
    child = np.empty((n_nodes, 2), np.int32)
    depth = np.empty((n_nodes,), np.int32)
    order = np.empty((t,), np.int64)
    handle.bvh_get_nodes(bounds.ctypes.data_as(fp), child.ctypes.data_as(ip),
                         depth.ctypes.data_as(ip))
    handle.bvh_get_order(order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    handle.bvh_free()
    return bounds, child, depth, order
