"""The minimum end-to-end forward pipeline (SURVEY.md §7 stage 2).

One jittable function: scene + camera -> shaded image. This is the v1 slice;
the frame-graph version (renderer_jax.graph) decomposes it into declared
passes with conditional culling, mirroring the reference's
cull -> depth prepass -> main pass chain.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from renderer_jax.mathx.camera import Camera
from renderer_jax.ops import geometry, shading
from renderer_jax.ops.raster_jax import rasterize
from renderer_jax.scene.types import Scene


@partial(
    jax.jit,
    static_argnames=("width", "height", "tri_capacity", "cull_backface"),
)
def render_forward(
    scene: Scene,
    camera: Camera,
    width: int = 256,
    height: int = 256,
    tri_capacity: int = 2048,
    cull_backface: bool = True,
):
    """Render the scene. Returns (image (H,W,3) linear f32, visibility buffer).

    The whole frame is ONE XLA program: instance matrices, coarse frustum
    cull, draw-stream expansion, per-triangle cull, rasterization, deferred
    shading. No host round-trips (the analogue of the reference's
    zero-CPU-per-frame goal)."""
    model = geometry.instance_matrices(scene)
    vp, clip_mats = geometry.camera_clip_matrices(camera, model)
    visible = geometry.coarse_cull(scene, model, vp)
    lod = geometry.select_lod(scene, camera, model)
    soup = geometry.expand_draw_stream(
        scene, visible, lod, clip_mats, model, tri_capacity
    )
    soup = geometry.cull_triangles(soup, cull_backface=cull_backface)
    vis = rasterize(
        soup.clip, soup.valid, width, height, cull_backface=cull_backface
    )
    import jax.numpy as jnp

    img = shading.shade_lambert(
        vis, soup, scene, camera.position, viewproj_inv=jnp.linalg.inv(vp)
    )
    return img, vis
