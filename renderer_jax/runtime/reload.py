"""Kernel live-reload: the reference's shader_reload system for jitted kernels.

The reference watches compiled .spv files with `notify`, revalidates the new
shader's interface against the pipeline's static reflection, and swaps the
SmartPipeline — keeping the old pipeline when validation fails
(src/renderer/systems/shader_reload.rs:1-66,
renderer.rs:687-753).

Here "shaders" are Python modules of jax ops. The reloader mtime-watches
them, re-imports on change, rebuilds the frame graph through a caller
callback, re-validates it (graph.validate() = the interface check), and
swaps it into the Renderer — invalidating the plan cache and every jitted
program so the next frame re-traces through the new kernel code. On any
reload/validation failure the old graph keeps rendering and the error is
recorded, matching the reference's keep-old-pipeline behavior.
"""

from __future__ import annotations

import importlib
import os
from typing import Callable, Iterable, Optional


def _default_watch_modules():
    import renderer_jax.ops as ops_pkg
    import renderer_jax.passes as passes_pkg

    mods = []
    for pkg in (ops_pkg, passes_pkg):
        pkg_dir = os.path.dirname(pkg.__file__)
        for fn in sorted(os.listdir(pkg_dir)):
            if fn.endswith(".py") and not fn.startswith("_"):
                mods.append(f"{pkg.__name__}.{fn[:-3]}")
    return mods


class KernelReloader:
    """Watches kernel modules; hot-swaps the renderer's frame graph.

    renderer: runtime.Renderer (needs .graph/.plans/._jitted)
    rebuild:  zero-arg callable returning a fresh FrameGraph (typically
              lambda: build_forward_graph(cfg)); defaults to rebuilding the
              forward graph from renderer.cfg.
    modules:  module names to watch; defaults to every renderer_jax.ops /
              renderer_jax.passes module.
    """

    def __init__(
        self,
        renderer,
        rebuild: Optional[Callable] = None,
        modules: Optional[Iterable[str]] = None,
    ):
        self.renderer = renderer
        self._rebuild = rebuild or self._default_rebuild
        self.modules = list(modules) if modules is not None else _default_watch_modules()
        self._mtimes = {m: self._mtime(m) for m in self.modules}
        self.stats = {"reloads": 0, "failures": 0}
        self.last_error: Optional[str] = None

    def _default_rebuild(self):
        from renderer_jax.passes import pipeline as pl

        return pl.build_forward_graph(self.renderer.cfg)

    @staticmethod
    def _mtime(module_name: str) -> float:
        mod = importlib.import_module(module_name)
        try:
            return os.stat(mod.__file__).st_mtime
        except OSError:
            return 0.0

    def changed(self) -> list:
        """Module names whose source changed since the last poll."""
        out = []
        for m in self.modules:
            t = self._mtime(m)
            if t != self._mtimes[m]:
                out.append(m)
        return out

    def poll(self) -> bool:
        """Reload changed modules and hot-swap the graph. Returns True when
        a swap happened. Call once per frame (cheap: one stat per module)."""
        changed = self.changed()
        if not changed:
            return False
        try:
            for m in changed:
                mod = importlib.import_module(m)
                importlib.reload(mod)
                self._mtimes[m] = self._mtime(m)
            new_graph = self._rebuild()
            new_graph.validate()  # interface revalidation (spirq analogue)
        except Exception as e:  # keep the old pipeline rendering
            self.stats["failures"] += 1
            self.last_error = f"{type(e).__name__}: {e}"
            # remember the new mtimes so a broken save doesn't retrigger
            # every frame; the next edit re-attempts
            for m in changed:
                self._mtimes[m] = self._mtime(m)
            return False
        r = self.renderer
        r.graph = new_graph
        r.plans.graph = new_graph
        r.plans._cache.clear()
        r._jitted.clear()
        self.stats["reloads"] += 1
        self.last_error = None
        return True
