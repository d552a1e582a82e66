"""LOD generation via the native grid-clustering simplifier.

The meshopt-parity component (ref: simplify_sloppy LOD chains,
scene_loader.rs:739-756). LOD indices reference the ORIGINAL vertex pool, so
chains drop straight into MeshLibrary's LOD directory.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from renderer_jax.native.build import load_native

_SRC = os.path.join(os.path.dirname(__file__), "..", "native", "meshproc.cc")


def _load():
    lib = load_native(_SRC)
    if not hasattr(lib.rtpu_simplify_cluster, "_rtpu_typed"):
        lib.rtpu_simplify_cluster.restype = ctypes.c_int
        lib.rtpu_simplify_cluster.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rtpu_simplify_cluster._rtpu_typed = True
    return lib


def simplify(positions: np.ndarray, indices: np.ndarray, grid_size: int) -> np.ndarray:
    """Cluster-simplify: returns a new (T', 3) i32 index array referencing the
    ORIGINAL vertices. Smaller grid_size = coarser."""
    lib = _load()
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(indices, np.int32).reshape(-1, 3)
    out = np.empty_like(idx)
    out_t = ctypes.c_int64(0)
    rc = lib.rtpu_simplify_cluster(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pos),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(idx),
        grid_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.byref(out_t),
    )
    if rc != 0:
        raise ValueError(f"simplify_cluster failed (rc={rc})")
    return out[: out_t.value].copy()


def build_lod_chain(
    positions: np.ndarray,
    indices: np.ndarray,
    levels: int = 3,
    base_grid: int = 16,
) -> list:
    """LOD1..LODn index arrays (halving grid resolution per level, like the
    reference's successive simplify_sloppy targets). Stops early if a level
    fails to reduce the triangle count."""
    lods = []
    prev_count = len(indices)
    grid = base_grid
    while len(lods) < levels and grid >= 2:
        idx = simplify(positions, indices, grid)
        if 0 < len(idx) < prev_count:
            lods.append(idx)
            prev_count = len(idx)
        # no reduction at this grid (mesh too sparse): just go coarser
        grid //= 2
    return lods
