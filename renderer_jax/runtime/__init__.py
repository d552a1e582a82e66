"""Frame runtime: the replacement for the reference's submission engine +
main loop (RenderFrame/Submissions, renderer.rs:152-3878; main.rs frame loop).

Under XLA there are no queues or semaphores to manage — the runtime's jobs are:
plan selection by runtime switches, jit-compiled program caching, persistent
state carry with buffer donation (the DoubleBuffered analogue), and frame
pacing/statistics.
"""

from renderer_jax.runtime.autocap import AutoCapacityRenderer  # noqa: F401
from renderer_jax.runtime.frame import Renderer, RuntimeConfig  # noqa: F401
from renderer_jax.runtime.reload import KernelReloader  # noqa: F401
