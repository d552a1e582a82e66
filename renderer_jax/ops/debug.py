"""Debug visualizations: AABB box rendering.

The reference's debug_aabbs switch replaces scene geometry with its culling
volumes (debug_aabb_renderer.rs + renderer.rs:1561-1586, LINE-polygon boxes).
Here the AABBs become a solid-box triangle soup with flat per-instance colors
(lines have no array-friendly analogue; solid boxes show the same information).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from renderer_jax.ops.geometry import TriangleSoup
from renderer_jax.scene.types import Scene

# unit box corners (8, 3) in {-1, 1} and outward-wound triangles (12, 3)
_CORNERS = np.array(
    [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32
)
# corner index: bit2=x, bit1=y, bit0=z (0 => -1)
_BOX_TRIS = np.array(
    [
        [0, 1, 3], [0, 3, 2],  # -x
        [4, 6, 7], [4, 7, 5],  # +x
        [0, 4, 5], [0, 5, 1],  # -y
        [2, 3, 7], [2, 7, 6],  # +y
        [0, 2, 6], [0, 6, 4],  # -z
        [1, 5, 7], [1, 7, 3],  # +z
    ],
    np.int32,
)


def aabb_soup(
    scene: Scene, visible: jnp.ndarray, clip_mats: jnp.ndarray, model: jnp.ndarray,
    capacity: int,
) -> TriangleSoup:
    """Triangle soup of every visible instance's world-space AABB box.

    Boxes are built in object space from the mesh AABB so the instance's
    model matrix applies directly (same path as real geometry)."""
    from renderer_jax.ops.geometry import mats44

    clip_mats = mats44(clip_mats)
    model = mats44(model)
    inst = scene.instances
    n = inst.mesh_id.shape[0]
    mn = scene.meshes.mesh_aabb_min[inst.mesh_id]  # (N, 3)
    mx = scene.meshes.mesh_aabb_max[inst.mesh_id]
    center = (mn + mx) * 0.5
    extent = (mx - mn) * 0.5

    corners = center[:, None, :] + extent[:, None, :] * _CORNERS[None]  # (N, 8, 3)
    tri_pos = corners[:, _BOX_TRIS]  # (N, 12, 3, 3)

    ones = jnp.ones(tri_pos.shape[:-1] + (1,), tri_pos.dtype)
    h = jnp.concatenate([tri_pos, ones], axis=-1)  # (N, 12, 3, 4)
    clip = jnp.einsum("nij,ntkj->ntki", clip_mats, h, precision="highest")

    # face normals from the box template (object space, rotated by model)
    e1 = tri_pos[:, :, 1] - tri_pos[:, :, 0]
    e2 = tri_pos[:, :, 2] - tri_pos[:, :, 0]
    fn = jnp.cross(e1, e2)
    fn = jnp.einsum("nij,ntj->nti", model[:, :3, :3], fn, precision="highest")
    normal = jnp.repeat(fn[:, :, None, :], 3, axis=2)  # (N, 12, 3, 3)

    t_total = n * 12
    owner = jnp.repeat(jnp.arange(n, dtype=jnp.int32), 12)
    valid_full = jnp.repeat(visible, 12)

    def flat(x):
        return x.reshape((t_total,) + x.shape[2:])

    soup = TriangleSoup(
        clip=flat(clip),
        normal=flat(normal),
        uv=jnp.zeros((t_total, 3, 2), jnp.float32),
        tangent=jnp.zeros((t_total, 3, 4), jnp.float32),
        instance=owner,
        valid=valid_full,
        count=jnp.sum(visible.astype(jnp.int32)) * 12,
        tex_lod=jnp.zeros((t_total,), jnp.float32),
        tri_idx=jnp.zeros((t_total,), jnp.int32),
    )
    # clamp/pad to capacity
    if t_total >= capacity:
        soup = TriangleSoup(*[x[:capacity] if hasattr(x, "shape") and x.ndim > 0 else x for x in soup])
    else:
        pad = capacity - t_total

        def padx(x):
            if x.ndim == 0:
                return x
            return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])

        soup = TriangleSoup(*[padx(x) for x in soup])
    return soup


def instance_debug_colors(instance_ids: jnp.ndarray) -> jnp.ndarray:
    """Deterministic distinct-ish colors per instance id (golden-ratio hue)."""
    h = (instance_ids.astype(jnp.float32) * 0.61803398875) % 1.0
    # cheap HSV->RGB with s=0.7, v=0.9
    i = jnp.floor(h * 6.0)
    f = h * 6.0 - i
    s, v = 0.7, 0.9
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i.astype(jnp.int32) % 6
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [v, q, p, p, t, v])
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [t, v, v, q, p, p])
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [p, p, t, v, v, q])
    return jnp.stack([r, g, b], axis=-1)
