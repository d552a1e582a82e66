"""Ray-traced shadows (the reference's RT runtime switch).

The reference's `rt` switch swaps shadow-map lookups for 8-sample ray-query
soft shadows against a TLAS (gltf_mesh.frag:136-160, acceleration
structures). Without RT-core BVH traversal, this realization rearranges
Moller-Trumbore so that, for a constant ray direction (directional lights),
ALL per-pixel dot products become three matmuls:

    with s = origin - v0 and triple-product identities,
        u = f * s.(d x e2),   v = f * s.(e1 x d),   t = f * s.(e1 x e2)
    so a (P, 3) origin block against a (3, 3B) matrix of precomputed
    per-triangle vectors yields every (u, v, t) at once.

Cost is O(pixels x triangles) — brute force, no BVH — so it targets
CesiumMan/Helmet-class caster counts (the `rt_scale` factor computes
occlusion at reduced resolution and upsamples). The binned light-space
traversal (ops/rt_grid.py) is the scalable path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def triangles_world(soup_clip: jnp.ndarray, viewproj_inv: jnp.ndarray) -> jnp.ndarray:
    """Soup clip positions -> world positions (T, 3, 3) via inverse viewproj
    (the soup stores no world data; see ops/geometry.TriangleSoup)."""
    w = jnp.einsum("ij,tkj->tki", viewproj_inv, soup_clip, precision="highest")
    ww = w[..., 3:4]
    return w[..., :3] / jnp.where(jnp.abs(ww) > 1e-12, ww, 1e-12)


def ray_shadow_directional(
    world: jnp.ndarray,    # (3, H, W) surface positions (channel-first)
    normal: jnp.ndarray,   # (3, H, W) geometric normals
    direction: jnp.ndarray,  # (3,) light direction (rays travel along it)
    tri: jnp.ndarray,      # (T, 3, 3) world-space triangles
    tri_valid: jnp.ndarray,  # (T,)
    count,                 # traced i32: live prefix bound
    eps: float = 1e-3,
    block: int = 128,
) -> jnp.ndarray:
    """(1, H, W) occlusion factor: 0 = shadowed, 1 = lit (hard shadows).

    Rays go from each surface point TOWARD the light (-direction)."""
    t_cap = tri.shape[0]
    pad = (-t_cap) % block
    if pad:
        tri = jnp.concatenate([tri, jnp.zeros((pad, 3, 3), tri.dtype)], 0)
        tri_valid = jnp.concatenate([tri_valid, jnp.zeros((pad,), bool)])
        t_cap += pad
    n_blocks = t_cap // block

    d = -direction / jnp.maximum(jnp.linalg.norm(direction), 1e-8)  # toward light
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    h = jnp.cross(jnp.broadcast_to(d, e2.shape), e2)          # d x e2
    a = jnp.sum(e1 * h, axis=-1)                               # det
    f = jnp.where(jnp.abs(a) > 1e-12, 1.0 / a, 0.0)
    c_u = h                                                    # s.(d x e2)
    c_v = jnp.cross(e1, jnp.broadcast_to(d, e1.shape))         # s.(e1 x d)
    c_t = jnp.cross(e1, e2)                                    # s.(e1 x e2)
    # pack per-triangle matrices: (T, 9) -> blocks (n_blocks, 3, 3*block)
    cols = jnp.concatenate([c_u, c_v, c_t], axis=-1)           # (T, 9)
    consts = jnp.stack(
        [jnp.sum(v0 * c_u, -1), jnp.sum(v0 * c_v, -1), jnp.sum(v0 * c_t, -1)], -1
    )  # (T, 3)
    live = tri_valid & (jnp.abs(a) > 1e-12)

    ch, hh, ww = world.shape
    p = hh * ww
    # offset origins along the normal to avoid self-intersection
    origin = (world + normal * eps).reshape(3, p).T  # (P, 3)

    cols_b = cols.reshape(n_blocks, block, 9)
    consts_b = consts.reshape(n_blocks, block, 3)
    f_b = f.reshape(n_blocks, block)
    live_b = live.reshape(n_blocks, block)
    n_live = jnp.minimum((count + block - 1) // block, n_blocks).astype(jnp.int32)

    def body(b, occluded):
        m = cols_b[b].reshape(block, 3, 3)  # (B, 3 quantities, 3)
        # (P, 3) @ (3, 3B): every s-dot at once as one matmul
        dots = jnp.einsum(
            "pk,bqk->pbq", origin, m, precision="highest"
        )  # (P, B, 3)
        s_dots = dots - consts_b[b][None]  # subtract v0 terms
        u = s_dots[..., 0] * f_b[b][None]
        v = s_dots[..., 1] * f_b[b][None]
        t = s_dots[..., 2] * f_b[b][None]
        hit = (
            (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps) & live_b[b][None]
        )
        return occluded | jnp.any(hit, axis=1)

    occluded = jax.lax.fori_loop(0, n_live, body, jnp.zeros((p,), bool))
    return jnp.where(occluded.reshape(1, hh, ww), 0.0, 1.0)


def rt_shadow_planes(
    world: jnp.ndarray,     # (3, H, W)
    normal: jnp.ndarray,    # (3, H, W)
    lights,                 # scene.lights
    tri: jnp.ndarray,
    tri_valid: jnp.ndarray,
    count,
    n_slots: int = 4,
    rt_scale: int = 2,
) -> jnp.ndarray:
    """(n_slots, H, W) per-SLOT occlusion. Computed at 1/rt_scale resolution
    and nearest-upsampled (the soft-shadow jitter of the reference's 8-sample
    query is approximated by the lower-frequency sampling).

    Iterates shadow SLOTS, not the light table: only lights granted a slot
    can trace, so the O(P x T) sweep runs at most n_slots times, and
    `lax.cond` skips it entirely for slots no directional light holds (a
    bench-shaped light table previously paid the full sweep per light and
    masked the result after)."""
    s = rt_scale
    w_ds = world[:, ::s, ::s]
    n_ds = normal[:, ::s, ::s]
    slot = lights.shadow_slot
    planes = []
    for si in range(n_slots):
        holds = lights.alive & (slot == si) & lights.directional
        has = jnp.any(holds)
        hsel = holds[:, None].astype(jnp.float32)
        direction = jnp.sum(lights.position * hsel, axis=0)
        occ = jax.lax.cond(
            has,
            lambda d: ray_shadow_directional(w_ds, n_ds, d, tri, tri_valid, count),
            lambda d: jnp.ones((1,) + w_ds.shape[1:], jnp.float32),
            direction,
        )
        if s > 1:
            occ = jnp.repeat(jnp.repeat(occ, s, axis=1), s, axis=2)
        planes.append(occ[0, : world.shape[1], : world.shape[2]])
    return jnp.stack(planes, axis=0)
