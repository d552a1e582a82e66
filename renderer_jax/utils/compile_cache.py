"""Cross-process XLA compilation cache.

The reference's build-time "crossbar" persists frame-graph analysis across
builds (macro_lib/macrolib.rs:505-518) so edits don't pay
full re-analysis. Here the analogue is XLA compilation of the frame
program, so jax's persistent compilation cache is enabled: the second
process start deserializes the compiled executable instead of recompiling.

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (jax reads
that variable itself, so no directory is set in code); otherwise one fixed
directory inside the checkout, CACHE_DIR (listed in .gitignore). A fixed
path matters: the path is part of the cache key.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def enable_persistent_cache() -> str:
    """Point jax at the on-disk compilation cache (idempotent) and lower the
    persistence thresholds so frame-sized programs always qualify."""
    import jax

    d = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
