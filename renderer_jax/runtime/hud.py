"""Text HUD: the imgui overlay's information, as a terminal panel.

The reference's imgui HUD shows VMA allocator stats, runtime toggles, camera
pose, frame timing, and a graph-dump button (ecs.rs:279-410). This renderer
is headless, so the same data renders as a stats panel (and the graph dump is
renderer_jax.graph.dot / dump()).
"""

from __future__ import annotations

import dataclasses


def format_hud(
    renderer,
    frame_stats=None,
    arena=None,
    streamer=None,
    extra: dict = None,
    soup=None,  # last frame's TriangleSoup: adds raster bin-overflow stats
    prepared=None,  # last frame's prepare tuple: adds capacity-overflow stats
) -> str:
    lines = ["=== renderer_jax HUD ==="]
    lines.append(
        f"frame {renderer.frame_number}  plans compiled: {renderer.stats['compiles']}"
        f"  last frame: {renderer.stats['last_ms']:.1f} ms"
    )
    if frame_stats is not None:
        s = frame_stats.summary()
        lines.append(
            f"fps: {s['fps']:.1f}  avg: {s['ms_avg']:.1f} ms  p99: {s['ms_p99']:.1f} ms"
        )
    cfgd = dataclasses.asdict(renderer.config)
    toggles = "  ".join(f"{k}={'on' if v else 'off'}" for k, v in cfgd.items())
    lines.append(f"switches: {toggles}")
    plan = renderer.plans.plan(renderer.config.as_dict())
    lines.append(
        "active passes: " + " -> ".join(p.name for p in plan.passes)
    )
    if arena is not None:
        a = arena.stats()
        lines.append(
            "staging arena: "
            f"{a['used']/1e6:.1f}/{a['capacity']/1e6:.1f} MB used, "
            f"peak {a['peak_used']/1e6:.1f} MB, live allocs {a['live_allocs']}, "
            f"largest free {a['largest_free_block']/1e6:.1f} MB "
            f"({a['free_block_count']} blocks)"
        )
    if streamer is not None:
        st = streamer.stats
        lines.append(
            f"streaming: {st['uploaded']}/{st['requested']} uploaded "
            f"({st['decoded'] - st['uploaded']} decoded+queued), "
            f"budget {streamer.budget}/frame"
        )
    if soup is not None and renderer.cfg.use_pallas:
        from renderer_jax.ops.raster_pallas import bin_overflow_tiles

        n = int(
            bin_overflow_tiles(
                soup.clip, soup.valid,
                renderer.cfg.width * renderer.cfg.ssaa,
                renderer.cfg.height * renderer.cfg.ssaa,
                cull_backface=renderer.cfg.cull_backface,
            )
        )
        lines.append(
            f"raster bins: {'OK' if n == 0 else f'{n} tiles OVERFLOWED (walk-all fallback)'}"
        )
    if prepared is not None:
        model, lod, visible = prepared[0], prepared[4], prepared[3]
        cfg = renderer.cfg
        if renderer.config.shadows:
            from renderer_jax.ops.shadow import (
                light_matrices_cube,
                shadow_caster_truncation,
            )

            mats = light_matrices_cube(
                renderer.scene.lights, prepared[5], prepared[6]
            )
            trunc = shadow_caster_truncation(
                renderer.scene, model, lod, mats, cfg.shadow_slots,
                cfg.shadow_tri_capacity or cfg.tri_capacity,
                slot_size=cfg.shadow_size,
                scene_min=prepared[5], scene_max=prepared[6],
            )
            t = [int(x) for x in trunc]
            lines.append(
                "shadow casters: "
                + ("OK" if not any(t) else f"DROPPED per slot {t} (raise shadow_tri_capacity)")
            )
        if cfg.cluster_cull and renderer.scene.meshes.cluster_data is not None:
            from renderer_jax.ops.geometry import cluster_budget_overflow

            ov = int(cluster_budget_overflow(
                renderer.scene, visible, lod, 2 * cfg.tri_capacity
            ))
            lines.append(
                "cluster budget: "
                + ("OK" if ov == 0 else f"{ov} clusters OVER (geometry dropped)")
            )
    if renderer.config.shadows and renderer.cfg.shadow_cache:
        cache = renderer.state.get("shadow_cache")
        if cache is not None:
            import numpy as np

            sig, cursor = cache[1], cache[2]
            sig = np.asarray(sig)
            # units = slots, or (slot, band) pairs under shadow_progressive
            units = sig.reshape(-1, sig.shape[-1])
            never = int(np.isnan(units).any(axis=-1).sum())
            lines.append(
                f"shadow atlas cache: {sig.shape[0]} slots"
                + (f" x {sig.shape[1]} bands" if sig.ndim == 3 else "")
                + f", {never} never-rendered units, budget "
                f"{renderer.cfg.shadow_update_budget or 'all-dirty'}/frame, "
                f"cursor {int(np.asarray(cursor))}"
            )
    pass_ms = renderer.stats.get("pass_ms")
    if pass_ms:
        lines.append("pass timings (device, diagnostic — see pass_timings()):")
        for name, ms in pass_ms.items():
            lines.append(f"  {name:<18s} {ms:7.2f} ms")
        lines.append(f"  {'SUM (unfused)':<18s} {sum(pass_ms.values()):7.2f} ms")
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    return "\n".join(lines)


def validate_frame(outputs, dump_path: str = None):
    """Crash forensics (ref: crash_debugging.rs buffer markers + dump on
    failed submit): host-side NaN/Inf check of frame outputs; on failure,
    dumps the offending arrays for post-mortem (default: the temp dir) and
    raises."""
    import os
    import tempfile

    import numpy as np

    dump_path = dump_path or os.path.join(tempfile.gettempdir(), "renderer_jax_crash.npz")

    bad = {}
    for name, value in outputs.items():
        leaves = value if isinstance(value, (list, tuple)) else [value]
        import jax

        for i, leaf in enumerate(jax.tree_util.tree_leaves(leaves)):
            arr = np.asarray(leaf)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                bad[f"{name}.{i}"] = arr
    if bad:
        np.savez(dump_path, **bad)
        raise FloatingPointError(
            f"non-finite values in frame outputs {sorted(bad)}; "
            f"state dumped to {dump_path}"
        )
