"""Deferred shading from the visibility buffer (simple models).

The fragment-shader stage of the reference (gltf_mesh.frag) re-expressed as
batched per-pixel array math, CHANNEL-FIRST (see ops/pbr.py for why).
Lambert is the fast/debug model; ops/pbr.py is the full GGX path.
"""

from __future__ import annotations

import jax.numpy as jnp

from renderer_jax.ops.geometry import TriangleSoup
from renderer_jax.ops.raster_jax import VisibilityBuffer, interpolate
from renderer_jax.ops.raster_spec import NO_TRIANGLE
from renderer_jax.scene.types import Scene


def shade_lambert(
    vis: VisibilityBuffer,
    soup: TriangleSoup,
    scene: Scene,
    camera_pos: jnp.ndarray,
    viewproj_inv: jnp.ndarray = None,
    background=(0.05, 0.05, 0.08),
    ambient: float = 0.15,
    y0=0,
    full_height: int = None,
) -> jnp.ndarray:
    """Lambert-shaded linear RGB image (H, W, 3)."""
    from renderer_jax.ops.geometry import unproject_depth

    covered = vis.tri_id != NO_TRIANGLE
    safe_id = jnp.maximum(vis.tri_id, 0)

    h, w = vis.depth.shape
    world = unproject_depth(
        vis.depth, viewproj_inv, w, h, y0=y0, full_height=full_height
    )  # (3, H, W)
    normal = interpolate(vis, soup.normal)  # (3, H, W)
    nlen = jnp.sqrt(jnp.sum(normal * normal, axis=0, keepdims=True))
    n = normal / jnp.maximum(nlen, 1e-8)

    inst = soup.instance[safe_id]  # (H, W)
    mat_id = scene.instances.material_id[inst]
    albedo = jnp.stack(
        [scene.materials.base_color_factor[:, c][mat_id] for c in range(3)], axis=0
    )
    emissive = jnp.stack(
        [scene.materials.emissive[:, c][mat_id] for c in range(3)], axis=0
    )

    lights = scene.lights
    radiance = jnp.full_like(albedo, ambient)
    for li in range(lights.alive.shape[0]):
        on = lights.alive[li]
        to_light = jnp.where(
            lights.directional[li],
            -lights.position[li][:, None, None] * jnp.ones_like(world),
            lights.position[li][:, None, None] - world,
        )
        dist2 = jnp.sum(to_light * to_light, axis=0, keepdims=True)
        l = to_light / jnp.sqrt(jnp.maximum(dist2, 1e-12))
        ndotl = jnp.maximum(jnp.sum(n * l, axis=0, keepdims=True), 0.0)
        atten = jnp.where(lights.directional[li], 1.0, 1.0 / jnp.maximum(dist2, 1e-4))
        contrib = ndotl * atten * lights.intensity[li] * lights.color[li][:, None, None]
        radiance = radiance + jnp.where(on, contrib, 0.0)

    color = albedo * radiance + emissive
    bg = jnp.asarray(background, jnp.float32)[:, None, None]
    color = jnp.where(covered[None], color, bg)
    return jnp.moveaxis(color, 0, -1)


def shade_flat_instance(
    vis: VisibilityBuffer,
    soup: TriangleSoup,
    background=(0.05, 0.05, 0.08),
) -> jnp.ndarray:
    """Flat per-instance debug colors (the debug_aabbs view,
    ref: debug_aabb_renderer.rs constant-color boxes)."""
    from renderer_jax.ops.debug import instance_debug_colors

    covered = vis.tri_id != NO_TRIANGLE
    safe_id = jnp.maximum(vis.tri_id, 0)
    inst = soup.instance[safe_id]
    color = jnp.moveaxis(instance_debug_colors(inst), -1, 0)  # (3, H, W)
    # cheap shading cue: modulate by facing (bary-interpolated normal y)
    n = interpolate(vis, soup.normal)  # (3, H, W)
    ny = jnp.abs(n[1:2]) * 0.3 + 0.7
    bg = jnp.asarray(background, jnp.float32)[:, None, None]
    out = jnp.where(covered[None], color * ny, bg)
    return jnp.moveaxis(out, 0, -1)
