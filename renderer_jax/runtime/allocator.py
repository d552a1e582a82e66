"""ctypes bindings for the native staging-arena allocator.

Python-facing equivalent of the reference's vma/src/lib.rs wrapper: Arena
hands out numpy views over arena memory for zero-copy staging of scene
uploads, and `stats()` feeds the HUD (ref: vmaCalculateStats ->
imgui, ecs.rs:314-328).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from renderer_jax.native.build import load_native

_SRC = os.path.join(os.path.dirname(__file__), "..", "native", "arena.cc")


class ArenaStats(ctypes.Structure):
    _fields_ = [
        ("capacity", ctypes.c_uint64),
        ("used", ctypes.c_uint64),
        ("free_bytes", ctypes.c_uint64),
        ("peak_used", ctypes.c_uint64),
        ("live_allocs", ctypes.c_uint64),
        ("total_allocs", ctypes.c_uint64),
        ("failed_allocs", ctypes.c_uint64),
        ("largest_free_block", ctypes.c_uint64),
        ("free_block_count", ctypes.c_uint64),
    ]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


def _load():
    lib = load_native(_SRC)
    if not hasattr(lib.rtpu_arena_create, "_rtpu_typed"):
        lib.rtpu_arena_create.restype = ctypes.c_void_p
        lib.rtpu_arena_create.argtypes = [ctypes.c_uint64]
        lib.rtpu_arena_destroy.argtypes = [ctypes.c_void_p]
        lib.rtpu_arena_alloc.restype = ctypes.c_void_p
        lib.rtpu_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.rtpu_arena_free.restype = ctypes.c_int
        lib.rtpu_arena_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.rtpu_arena_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ArenaStats)]
        lib.rtpu_arena_create._rtpu_typed = True
    return lib


class Arena:
    """A host staging arena. Allocations come back as numpy arrays viewing
    arena memory (zero copy); free() returns them to the pool."""

    def __init__(self, capacity: int):
        self._lib = _load()
        self._handle = self._lib.rtpu_arena_create(capacity)
        if not self._handle:
            raise MemoryError(f"failed to create arena of {capacity} bytes")
        self.capacity = capacity
        self._live: dict[int, int] = {}  # ptr -> nbytes

    def alloc(self, shape, dtype=np.uint8, align: int = 64) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        ptr = self._lib.rtpu_arena_alloc(self._handle, max(nbytes, 1), align)
        if not ptr:
            raise MemoryError(
                f"arena alloc of {nbytes} bytes failed (stats: {self.stats()})"
            )
        buf = (ctypes.c_uint8 * max(nbytes, 1)).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype, count=int(np.prod(shape))).reshape(shape)
        self._live[ptr] = nbytes
        return arr

    def free(self, arr: np.ndarray) -> None:
        # identify by base data pointer (pass the original array, not a view)
        ptr = arr.ctypes.data
        if ptr not in self._live:
            raise ValueError("array was not allocated from this arena")
        rc = self._lib.rtpu_arena_free(self._handle, ctypes.c_void_p(ptr))
        if rc != 0:
            raise ValueError("native free failed (double free?)")
        del self._live[ptr]

    def stats(self) -> dict:
        s = ArenaStats()
        self._lib.rtpu_arena_stats(self._handle, ctypes.byref(s))
        return s.as_dict()

    def close(self) -> None:
        if self._handle:
            self._lib.rtpu_arena_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
