"""The Renderer: per-frame driver around a frame graph.

Responsibilities (and their reference counterparts):
- plan selection + memoized compile per switch set
  (setup_submissions' cached plan rebuild, renderer.rs:3368-3606);
- one jax.jit program per plan, with the persistent-state pytree DONATED so
  XLA reuses the same HBM buffers frame-over-frame (the DoubleBuffered /
  frames-in-flight machinery, device/double_buffered.rs);
- two-frame switch latching (FutureRuntimeConfiguration, ecs.rs:240-277):
  switch edits land in `pending` and take effect next frame, so a frame
  always executes a consistent configuration;
- frame counters and simple timing stats (the imgui HUD data source).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax

from renderer_jax.graph.core import CompiledPlan, PlanCache
from renderer_jax.mathx.camera import Camera
from renderer_jax.passes.pipeline import PipelineConfig, build_forward_graph
from renderer_jax.scene.types import Scene


@dataclasses.dataclass
class RuntimeConfig:
    """Runtime switches (ref: RuntimeConfiguration, ecs.rs:240-258)."""

    freeze_culling: bool = False
    debug_aabbs: bool = False
    shadows: bool = False
    occlusion_culling: bool = False
    rt: bool = False
    hud: bool = False  # burn the 2D overlay into the frame (imgui pass)
    # composite a low-res XLA-reference diff heatmap (ref: reference_rt)
    reference_image: bool = False

    def as_dict(self) -> dict:
        # vars() copy, not dataclasses.asdict: asdict's recursive deepcopy
        # is host time in the render loop (flat bool fields only, so a
        # shallow copy is equivalent)
        return dict(vars(self))


class Renderer:
    def __init__(
        self,
        scene: Scene,
        cfg: Optional[PipelineConfig] = None,
        graph=None,
        outputs=("image", "vis"),
        spmd_mesh=None,  # jax Mesh: run THE SAME plan SPMD across its axis
    ):
        from renderer_jax.utils.compile_cache import enable_persistent_cache

        enable_persistent_cache()  # crossbar analogue: warm process starts
        self.cfg = cfg or PipelineConfig()
        # the render()-time light-count contract only applies when the
        # prefix bound was AUTO-derived from the construction scene; an
        # explicit shade_light_slots (e.g. "shade 2 of 16 lights like the
        # reference's shader") is the caller's own statement
        self._auto_light_slots = self.cfg.shade_light_slots is None
        if self.cfg.shade_light_slots is None:
            # static light-slot specialization: shade only the scene's live
            # prefix of the light table (the reference hard-codes 2 lights in
            # gltf_mesh.frag; dead slots otherwise pay a full GGX each). The
            # count is concrete at construction; scenes passed to render()
            # later must not grow their live-light count past it.
            import numpy as np

            self.cfg = dataclasses.replace(
                self.cfg, shade_light_slots=int(np.asarray(scene.lights.count))
            )
        if self.cfg.static_light_casts is None:
            # static light-cast specialization (same contract): the scene's
            # (shadow_slot, directional) pattern is compiled in, removing
            # the per-light casts/is_point conds from the shadowed shade.
            # Scenes passed to render() later must keep the same pattern.
            import numpy as np

            k = self.cfg.shade_light_slots
            slots = np.asarray(scene.lights.shadow_slot)[:k]
            dirs = np.asarray(scene.lights.directional)[:k]
            alive = np.asarray(scene.lights.alive)[:k]
            self.cfg = dataclasses.replace(
                self.cfg,
                static_light_casts=tuple(
                    (int(s) if a else -1, bool(d))
                    for s, d, a in zip(slots, dirs, alive)
                ),
            )
        self.spmd_mesh = spmd_mesh
        if spmd_mesh is not None:
            assert self.cfg.spmd_devices == spmd_mesh.shape[self.cfg.spmd_axis], (
                "PipelineConfig.spmd_devices must match the mesh axis size"
            )
        self.graph = graph or build_forward_graph(self.cfg)
        self.plans = PlanCache(self.graph, outputs=outputs)
        self.scene = self._on_mesh(scene)
        self.config = RuntimeConfig()
        self._pending_config = RuntimeConfig()
        state = self.plans.plan().initial_state()
        self.state = self._on_mesh(state, {k: self._spec_of(k) for k in state})
        self.frame_number = 1  # ref: frame_number starts at 1, renderer.rs:968
        self._jitted: dict[tuple, object] = {}
        self.stats = {"frames": 0, "last_ms": 0.0, "compiles": 0}

    # -- configuration (two-frame latch) ------------------------------------
    def set_config(self, **kwargs) -> None:
        """Edit runtime switches; takes effect NEXT frame (ref two-frame
        latch shift_runtime_config, ecs.rs:270-277)."""
        for k, v in kwargs.items():
            if not hasattr(self._pending_config, k):
                raise AttributeError(f"unknown runtime switch {k!r}")
            setattr(self._pending_config, k, bool(v))

    def apply_config_now(self) -> None:
        """Skip the two-frame latch (CLI/startup): copy pending -> active.
        A COPY, not an alias — aliasing would let later set_config edits
        mutate the live config mid-frame."""
        self.config = dataclasses.replace(self._pending_config)

    def _on_mesh(self, tree, specs=None):
        """SPMD: `tree` placed on the mesh, replicated or with the given
        per-key partition specs. The scene and the persistent state enter
        the plan already placed as it takes them: a scene left on one device
        is broadcast from there on every frame, and state placed otherwise
        than the plan returns it compiles the plan a second time. Leaves
        already placed are not copied, so a scene override built from
        `self.scene` moves only what it replaced."""
        if self.spmd_mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec as P

        def place(spec):
            return jax.tree.map(
                lambda p: NamedSharding(self.spmd_mesh, p), spec,
                is_leaf=lambda x: isinstance(x, P),
            )

        if specs is None:
            return jax.device_put(tree, place(P()))
        return jax.device_put(tree, {k: place(specs[k]) for k in tree})

    def _spec_of(self, name):
        """The SPMD partition spec of a graph resource (declared on the
        resource; replicated when it declares none)."""
        from jax.sharding import PartitionSpec as P

        s = self.graph.resources[name].spmd_specs
        return s if s is not None else P()

    def _external_names(self) -> set:
        return {
            r.name for r in self.graph.resources.values() if r.external
        }

    def _jit_for(self, plan: CompiledPlan):
        key = tuple(sorted(plan.switches.items()))
        if key not in self._jitted:
            declared = self._external_names()

            def run(state, scene, camera, t, overlay):
                ext = {"scene": scene, "camera": camera, "time": t, "overlay": overlay}
                return plan.execute(
                    state, **{k: v for k, v in ext.items() if k in declared}
                )

            if self.spmd_mesh is not None:
                # one shard_map over the WHOLE plan: per-resource partition
                # specs come from the graph declarations (vis row-sharded,
                # everything else replicated); scene/camera replicated
                from jax.sharding import PartitionSpec as P

                state_specs = {name: self._spec_of(name) for name in self.state}
                out_specs = (
                    {o: self._spec_of(o) for o in plan.outputs},
                    state_specs,
                )
                run = jax.shard_map(
                    run,
                    mesh=self.spmd_mesh,
                    in_specs=(state_specs, P(), P(), P(), P()),
                    out_specs=out_specs,
                    # pallas_call outputs carry no varying-mesh-axes
                    # annotation; skip the vma check (specs above are the
                    # source of truth)
                    check_vma=False,
                )
            self._jitted[key] = jax.jit(run, donate_argnums=0)
            self.stats["compiles"] += 1
        return self._jitted[key]

    # -- frame ---------------------------------------------------------------
    def render(
        self, camera: Camera, scene: Optional[Scene] = None, time_s=0.0,
        overlay=None,
    ):
        """Render one frame; returns the outputs dict (device arrays).
        time_s drives animation clips (the pose pass); overlay is the 2D
        instance table composited when the hud switch is on."""
        if scene is not None:
            if scene.lights is not self.scene.lights:
                self._check_light_contract(scene)
            self.scene = self._on_mesh(scene)
        if overlay is None:
            from renderer_jax.ops.overlay import Overlay

            if not hasattr(self, "_empty_overlay"):
                self._empty_overlay = Overlay.empty()
            overlay = self._empty_overlay
        # steady-state fast path: the compiled plan memoized by config value
        # (rebuilding the switch dict + plan-cache keys is per-frame host
        # tail). The JITTED fn is NOT memoized:
        # _jit_for's dict lookup is cheap and kernel live-reload invalidates
        # Renderer._jitted behind our back.
        cached = getattr(self, "_plan_memo", None)
        if cached is not None and cached[0] == self.config:
            plan = cached[1]
        else:
            plan = self.plans.plan(self.config.as_dict())
            self._plan_memo = (dataclasses.replace(self.config), plan)
        fn = self._jit_for(plan)
        t0 = time.perf_counter()
        import numpy as np

        outputs, self.state = fn(
            # np.float32, NOT jnp: an eager jnp scalar is a per-frame device
            # dispatch before the real program
            self.state, self.scene, camera, np.float32(time_s), overlay
        )
        self.stats["last_ms"] = (time.perf_counter() - t0) * 1e3
        self.stats["frames"] += 1
        self.frame_number += 1
        # latch pending config for the next frame (copy only on change)
        if self.config != self._pending_config:
            self.config = dataclasses.replace(self._pending_config)
        return outputs

    def _check_light_contract(self, scene) -> None:
        """Validate a scene override against the compiled-in light
        specializations: shade_light_slots and
        static_light_casts bake the construction scene's live-light count
        and (shadow_slot, directional, alive) pattern into the compiled
        shade — a scene whose pattern differs would silently shade wrong
        (the dynamic lax.cond path is compiled out). Checked only when the
        lights pytree IDENTITY changes (render() caches the last validated
        object): the common per-frame paths — no override, or gameplay
        churn that keeps the same lights arrays — pay nothing, and the
        small device->host fetch (a few dozen scalars) happens once per
        distinct lights table, not per frame."""
        import numpy as np

        lid = id(scene.lights)
        if lid == getattr(self, "_validated_lights_id", None):
            return
        cfg = self.cfg
        k = cfg.shade_light_slots
        count = int(np.asarray(scene.lights.count))
        if self._auto_light_slots and count > k:
            raise ValueError(
                f"scene has {count} live lights but the Renderer was "
                f"compiled for {k} (shade_light_slots); construct a new "
                "Renderer or pass shade_light_slots explicitly"
            )
        if cfg.static_light_casts:  # () = dynamic-cond opt-out, no contract
            slots = np.asarray(scene.lights.shadow_slot)[:k]
            dirs = np.asarray(scene.lights.directional)[:k]
            alive = np.asarray(scene.lights.alive)[:k]
            pattern = tuple(
                (int(s) if a else -1, bool(d))
                for s, d, a in zip(slots, dirs, alive)
            )
            if pattern != cfg.static_light_casts:
                raise ValueError(
                    "scene override changes the light cast pattern "
                    f"{cfg.static_light_casts} -> {pattern}; the shade was "
                    "compiled with static_light_casts (construct a new "
                    "Renderer, or pass static_light_casts=() to keep the "
                    "dynamic per-light conds)"
                )
        self._validated_lights_id = lid

    def block(self, outputs) -> None:
        jax.block_until_ready(outputs)

    # -- diagnostics ---------------------------------------------------------
    def pass_timings(self, camera: Camera, time_s=0.0, overlay=None, iters=5):
        """Per-pass device timings for the CURRENT plan (diagnostic mode —
        see CompiledPlan.execute_timed). Does not advance frame state.
        Feeds the HUD's timing table (the reference's per-system GPU
        timestamp panel, ecs.rs:293-409)."""
        if overlay is None:
            from renderer_jax.ops.overlay import Overlay

            overlay = Overlay.empty()
        plan = self.plans.plan(self.config.as_dict())
        declared = self._external_names()
        ext = {
            "scene": self.scene, "camera": camera,
            "time": jax.numpy.float32(time_s), "overlay": overlay,
        }
        _, _, timings = plan.execute_timed(
            self.state, iters=iters,
            **{k: v for k, v in ext.items() if k in declared},
        )
        self.stats["pass_ms"] = timings
        return timings
