"""Automatic triangle-capacity budgeting.

The reference sizes its culled-output buffers once, at a worst-case design
constant (20M indices, generate_work.comp:36-50) — a desktop GPU writes
only the culled prefix, so oversizing costs memory, not time. Here the
capacity is a COMPILED constant and much of the frame cost scales with
it, so a fixed worst-case capacity taxes every frame.

AutoCapacityRenderer removes the operator-set knob: it keeps a ladder of
capacity tiers (each tier one compiled plan family, memoized) and every
`check_every` frames fetches two scalars (outside the per-frame loop):
the TRUE expansion demand of the visible set (geometry.expansion_demand —
truncation-free, capacity-independent) and the post-cull draw-list count.
Then it re-plans:
- UP one tier when either crowds its ceiling (demand > up_frac *
  expand_capacity, or count > up_frac * tri_capacity — the draw-list
  count alone is NOT a truncation signal: expansion clamps silently
  upstream of it);
- DOWN when the demand would comfortably fit the tier below
  (< down_frac * its expand capacity), with hysteresis so a camera pan
  cannot thrash tiers.

Tier switches carry over every persistent resource whose shapes match
(vis, shadow cache, prev_vp — all capacity-independent); the draw list is
capacity-shaped and re-initializes, which the next cull pass rewrites
anyway (freeze_culling across a switch loses one frozen frame).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime.frame import Renderer
from renderer_jax.scene.types import Scene


def _shapes_match(a, b) -> bool:
    import jax

    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(
        getattr(x, "shape", None) == getattr(y, "shape", None)
        and getattr(x, "dtype", None) == getattr(y, "dtype", None)
        for x, y in zip(la, lb)
    )


class AutoCapacityRenderer:
    """Renderer facade that budgets tri_capacity from the measured frame."""

    def __init__(
        self,
        scene: Scene,
        cfg: Optional[PipelineConfig] = None,
        # powers of two plus 3*2^k mid-rungs: capacity cost is ~linear, so
        # a mid-rung saves ~25% whenever demand lands between octaves
        ladder: Sequence[int] = (
            1 << 14, 1 << 15, 1 << 16, 3 << 15, 1 << 17, 3 << 16,
            1 << 18, 3 << 17, 1 << 19,
        ),
        check_every: int = 8,
        up_frac: float = 0.85,
        down_frac: float = 0.6,
        outputs=("image",),
    ):
        self.cfg = cfg or PipelineConfig()
        self.ladder = sorted(int(c) for c in ladder)
        assert all(c % 256 == 0 for c in self.ladder)
        self.check_every = check_every
        self.up_frac = up_frac
        self.down_frac = down_frac
        self.outputs = tuple(outputs)
        self.scene = scene
        self._renderers: dict[int, Renderer] = {}
        self._tier = 0  # start at the smallest tier; first checks grow it
        self._frames = 0
        self.stats = {"tier_switches": 0, "last_count": 0, "last_demand": 0}

        import jax

        from renderer_jax.ops import geometry

        def _demand(scene, camera):
            prepared = geometry.prepare_frame_columns(scene, camera)
            return geometry.expansion_demand(scene, prepared[3], prepared[4])

        self._demand = jax.jit(_demand)

    @property
    def capacity(self) -> int:
        return self.ladder[self._tier]

    @property
    def renderer(self) -> Renderer:
        cap = self.capacity
        if cap not in self._renderers:
            cfg = dataclasses.replace(
                self.cfg, tri_capacity=cap, expand_capacity_=0
            )
            self._renderers[cap] = Renderer(
                self.scene, cfg, outputs=self.outputs
            )
        return self._renderers[cap]

    def set_config(self, **kwargs) -> None:
        # propagate runtime switches to every tier (compiled lazily)
        self._pending_switches = {
            **getattr(self, "_pending_switches", {}), **kwargs
        }
        self.renderer.set_config(**kwargs)
        self.renderer.apply_config_now()

    def _switch_tier(self, new_tier: int) -> None:
        old = self.renderer
        self._tier = new_tier
        new = self.renderer
        # carry runtime switches + every shape-compatible persistent state
        for k, v in getattr(self, "_pending_switches", {}).items():
            new.set_config(**{k: v})
        new.apply_config_now()
        for name, val in old.state.items():
            if name in new.state and _shapes_match(val, new.state[name]):
                new.state[name] = val
        self.stats["tier_switches"] += 1

    def render(self, camera, scene: Optional[Scene] = None, **kw):
        if scene is not None:
            self.scene = scene
        out = self.renderer.render(camera, scene=scene, **kw)
        self._frames += 1
        if self._frames % self.check_every == 0:
            demand = int(np.asarray(self._demand(self.scene, camera)))
            dl = self.renderer.state.get("draw_list")
            count = int(np.asarray(dl.count)) if dl is not None else 0
            self.stats["last_count"] = count
            self.stats["last_demand"] = demand
            cap = self.capacity
            expand_cap = 2 * cap  # expand_capacity_ = 0 -> 2x tri_capacity
            if (
                demand > self.up_frac * expand_cap
                or count > self.up_frac * cap
            ) and self._tier + 1 < len(self.ladder):
                self._switch_tier(self._tier + 1)
            elif (
                self._tier > 0
                and demand < self.down_frac * 2 * self.ladder[self._tier - 1]
                and count < self.down_frac * self.ladder[self._tier - 1]
            ):
                self._switch_tier(self._tier - 1)
        return out
