"""Build-and-load for the native C++ components.

Binaries are never committed: each source file is compiled on demand into
``.native_cache/`` in the checkout (listed in .gitignore), keyed by a
content hash of the source, so
a stale or wrong-arch binary can never be silently loaded (the hash IS the
filename) and rebuilds are exact rather than mtime-heuristic.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".native_cache",
)


def _cache_dir() -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return CACHE_DIR


def load_native(src_path: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Compile ``src_path`` (if its content hash isn't cached yet) and dlopen
    the resulting shared object."""
    src_path = os.path.abspath(src_path)
    with _lock:
        if src_path in _loaded:
            return _loaded[src_path]
        with open(src_path, "rb") as f:
            src = f.read()
        digest = hashlib.sha256(src + repr(sorted(extra_flags)).encode()).hexdigest()[:16]
        name = os.path.splitext(os.path.basename(src_path))[0]
        lib_path = os.path.join(_cache_dir(), f"lib{name}-{digest}.so")
        if not os.path.exists(lib_path):
            tmp = lib_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", *extra_flags,
                 src_path, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, lib_path)  # atomic: concurrent builders race safely
        lib = ctypes.CDLL(lib_path)
        _loaded[src_path] = lib
        return lib
