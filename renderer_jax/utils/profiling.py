"""Profiling & observability (the reference's Tracy + imgui HUD parity).

- `trace(dir)`: context manager around jax.profiler — produces an XPlane /
  Perfetto trace of device execution, the Tracy analogue
  (ref: tracing_on feature + finish_continuous_frame, main.rs:72-87, 912).
- Pass-level named scopes already wrap every frame-graph pass via
  jax.named_scope (graph/core.py execute), so traces show per-pass spans.
- `FrameStats` accumulates per-frame wall times and derives fps percentiles
  (the HUD's timing source).
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Capture a device profile (default: the temp dir): open with Perfetto /
    TensorBoard."""
    import os
    import tempfile

    import jax

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "renderer_jax_trace")

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def dump_hlo(fn, *args, path: str = None, optimized: bool = True) -> str:
    """Dump the (optimized) HLO of a jitted callable — the compiled-code
    inspection hook (parity with the reference's RGA .pso dumps, rga.rs)."""
    import jax

    lowered = jax.jit(fn).lower(*args)
    text = (
        lowered.compile().as_text() if optimized else lowered.as_text()
    )
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


class FrameStats:
    """Rolling frame-time statistics (ref: imgui frame timing, ecs.rs)."""

    def __init__(self, window: int = 120):
        self.window = window
        self.samples: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.window:
                self.samples.pop(0)
        self._last = now

    def summary(self) -> dict:
        if not self.samples:
            return {"fps": 0.0, "ms_avg": 0.0, "ms_p99": 0.0}
        s = sorted(self.samples)
        avg = sum(s) / len(s)
        p99 = s[min(len(s) - 1, int(len(s) * 0.99))]
        return {
            "fps": 1.0 / avg if avg > 0 else 0.0,
            "ms_avg": avg * 1e3,
            "ms_p99": p99 * 1e3,
        }
