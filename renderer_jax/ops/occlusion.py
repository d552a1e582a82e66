"""Two-pass occlusion culling with a hierarchical depth pyramid.

The reference lacks occlusion culling (SURVEY.md §7 stage 7 calls it out as
a BASELINE requirement the rebuild must add). Standard GPU-driven design
(and the CuRast/VR-Pipe pattern, PAPERS.md): build a mip pyramid over frame
N-1's depth buffer (max-reduction = farthest occluder per texel footprint);
at frame N, test every instance's screen-space bbox against the pyramid
level whose texel covers the bbox — if the bbox's nearest depth is farther
than the stored farthest occluder, the instance cannot be visible.

Frame N-1 depth arrives through the frame graph's reads_prev mechanism
(graph/core.py), so no host round-trips — and so does frame N-1's viewproj:
instances are projected with the PREVIOUS camera, so the depth test happens
in the space the depth buffer was rendered in. Under camera motion the test
is therefore still exact for static geometry; moving OBJECTS can be one
frame stale (conservative direction for approaching objects is not
guaranteed, the standard trade-off of two-pass occlusion culling — disocclusion
by a departing occluder pops the revealed object in one frame late).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.scene.types import Scene


def build_depth_pyramid(depth: jnp.ndarray, levels: int) -> list:
    """Max-mip chain over the depth buffer. depth: (H, W) with 1.0 = far.
    Returns [level0 (H/2,W/2), level1 (H/4,W/4), ...]. H, W must be divisible
    by 2^levels."""
    out = []
    d = depth
    for _ in range(levels):
        h, w = d.shape
        d = d.reshape(h // 2, 2, w // 2, 2).max(axis=(1, 3))
        out.append(d)
    return out


def occlusion_cull(
    scene: Scene,
    model: jnp.ndarray,
    viewproj_prev: jnp.ndarray,  # frame N-1 viewproj (match prev_depth space)
    visible: jnp.ndarray,
    prev_depth: jnp.ndarray,  # (H, W) frame N-1 depth
    levels: int = 6,
) -> jnp.ndarray:
    """Refine the coarse-cull mask using last frame's depth pyramid.

    Per instance: project the world AABB's 8 corners WITH LAST FRAME'S
    viewproj (the depth buffer's own space); take the screen bbox and
    nearest NDC depth; pick the pyramid level whose texel covers the bbox;
    one conservative 2x2-texel max lookup decides occlusion.
    Returns visible & ~occluded (N,).
    """
    from renderer_jax.ops.geometry import mats44

    model = mats44(model)
    viewproj = viewproj_prev
    h, w = prev_depth.shape
    pyramid = build_depth_pyramid(prev_depth, levels)

    inst = scene.instances
    mn = scene.meshes.mesh_aabb_min[inst.mesh_id]
    mx = scene.meshes.mesh_aabb_max[inst.mesh_id]
    wmin, wmax = mathx.transform_aabb(model, mn, mx)

    # 8 corners -> clip
    n = wmin.shape[0]
    sel = jnp.asarray(
        [[i & 4, i & 2, i & 1] for i in range(8)], jnp.bool_
    )  # (8, 3)
    corners = jnp.where(sel[None], wmax[:, None, :], wmin[:, None, :])  # (N, 8, 3)
    hcorn = jnp.concatenate([corners, jnp.ones((n, 8, 1), jnp.float32)], axis=-1)
    clip = jnp.einsum("ij,nkj->nki", viewproj, hcorn, precision="highest")
    cw = clip[..., 3]
    # any corner at/behind the near plane -> never occlusion-cull (unsafe)
    safe = jnp.all(cw > 1e-6, axis=-1)
    safe_w = jnp.where(jnp.abs(cw) > 1e-9, cw, 1e-9)
    ndc = clip[..., :3] / safe_w[..., None]
    px = (ndc[..., 0] + 1.0) * (0.5 * w)
    py = (1.0 - ndc[..., 1]) * (0.5 * h)
    zmin = jnp.min(ndc[..., 2], axis=-1)  # nearest depth of the instance
    x0 = jnp.clip(jnp.min(px, axis=-1), 0.0, w - 1.0)
    x1 = jnp.clip(jnp.max(px, axis=-1), 0.0, w - 1.0)
    y0 = jnp.clip(jnp.min(py, axis=-1), 0.0, h - 1.0)
    y1 = jnp.clip(jnp.max(py, axis=-1), 0.0, h - 1.0)

    # level whose texel (2^(l+1) px) covers the bbox's larger extent
    extent = jnp.maximum(x1 - x0, y1 - y0)
    lvl = jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(extent, 1.0))).astype(jnp.int32) - 1,
        0,
        levels - 1,
    )

    # gather a texel neighborhood at that level covering the bbox footprint:
    # 2x2 suffices for every level the lvl rule assigns (extent <= texel),
    # but big boxes CLAMP to the top level — there a 4x4 window covers
    # extents up to 3 top-texels, and anything larger must never cull
    # (sampling only a corner of a huge bbox once culled partially-visible
    # buildings in the city scene: visible counts oscillated 140k -> 2 ->
    # 128k as the over-culled frame emptied the next frame's pyramid).
    top_scale = 2 << (levels - 1)
    too_big = extent > 3.0 * top_scale
    occluded = jnp.zeros((n,), bool)
    for l in range(levels):  # static unroll; select the right level's answer
        d = pyramid[l]
        scale = 2 << l  # pixels per texel at this level
        lh, lw = d.shape
        taps = 4 if l == levels - 1 else 2
        tx0 = jnp.clip((x0 / scale).astype(jnp.int32), 0, lw - 1)
        ty0 = jnp.clip((y0 / scale).astype(jnp.int32), 0, lh - 1)
        far = None
        for dy in range(taps):
            ty = jnp.clip(ty0 + dy, 0, lh - 1)
            for dx in range(taps):
                tx = jnp.clip(tx0 + dx, 0, lw - 1)
                v = d[ty, tx]
                far = v if far is None else jnp.maximum(far, v)
        occ_l = zmin > far  # nearest point is behind the farthest occluder
        occluded = jnp.where(lvl == l, occ_l, occluded)

    return visible & ~(occluded & safe & ~too_big)
