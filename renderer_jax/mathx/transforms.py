"""Quaternions and batched TRS model matrices.

The reference computes one model matrix per entity on the CPU with a parallel
ECS system (src/ecs.rs:52-64 ``model_matrix_calculation``).
Here the whole scene's matrices are built in one batched computation that XLA
lowers to a handful of fused vector ops — transform application itself is a
batched matmul.

All functions accept arbitrary leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp


def quat_identity(dtype=jnp.float32) -> jnp.ndarray:
    """Identity rotation, (w, x, y, z)."""
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_from_axis_angle(axis: jnp.ndarray, angle) -> jnp.ndarray:
    """Unit quaternion rotating ``angle`` radians about ``axis`` (normalized here)."""
    axis = jnp.asarray(axis, dtype=jnp.float32)
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    angle = jnp.asarray(angle, dtype=jnp.float32)
    half = angle / 2.0
    w = jnp.cos(half)[..., None]
    xyz = axis * jnp.sin(half)[..., None]
    return jnp.concatenate([w, xyz], axis=-1)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product a*b (apply b's rotation, then a's)."""
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_to_mat3(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix from unit quaternion. Shape (..., 4) -> (..., 3, 3)."""
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    m = quat_to_mat3(q)
    return jnp.einsum("...ij,...j->...i", m, v, precision="highest")


def trs_matrix(
    translation: jnp.ndarray, rotation: jnp.ndarray, scale: jnp.ndarray
) -> jnp.ndarray:
    """4x4 model matrix M = T @ R @ S from (...,3) translation, (...,4) quat,
    (...,) or (...,3) scale. Mirrors the reference's Position/Rotation/Scale
    components (src/ecs/components.rs)."""
    translation = jnp.asarray(translation, jnp.float32)
    scale = jnp.asarray(scale, jnp.float32)
    if scale.ndim == translation.ndim - 1:
        scale = scale[..., None] * jnp.ones(3, jnp.float32)
    r = quat_to_mat3(rotation)
    rs = r * scale[..., None, :]  # scale columns
    batch = jnp.broadcast_shapes(rs.shape[:-2], translation.shape[:-1])
    rs = jnp.broadcast_to(rs, batch + (3, 3))
    t = jnp.broadcast_to(translation, batch + (3,))
    top = jnp.concatenate([rs, t[..., :, None]], axis=-1)  # (..., 3, 4)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def compose_model_matrices(
    translations: jnp.ndarray, rotations: jnp.ndarray, scales: jnp.ndarray
) -> jnp.ndarray:
    """Whole-scene batched model matrices: (N,3),(N,4),(N,)|(N,3) -> (N,4,4)."""
    return trs_matrix(translations, rotations, scales)


def transform_points(m: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply 4x4 matrix (..., 4, 4) to points (..., N, 3) -> (..., N, 3).

    One matmul per batch: the hot path of vertex transformation. Geometry
    needs full f32 (depth-test stability), so precision is pinned to highest —
    a default-precision f32 matmul may run in TF32 on the GPU."""
    ones = jnp.ones(pts.shape[:-1] + (1,), pts.dtype)
    h = jnp.concatenate([pts, ones], axis=-1)
    out = jnp.einsum("...ij,...nj->...ni", m, h, precision="highest")
    return out[..., :3]


def transform_aabb(m: jnp.ndarray, aabb_min: jnp.ndarray, aabb_max: jnp.ndarray):
    """Transform AABBs by model matrices using the |linear|-part trick
    (center/extent form), the standard exact bound for affine transforms.

    Replaces the reference's per-entity aabb_calculation
    (src/ecs.rs:138-181). Shapes (...,4,4),(...,3),(...,3).
    """
    center = (aabb_min + aabb_max) * 0.5
    extent = (aabb_max - aabb_min) * 0.5
    lin = m[..., :3, :3]
    t = m[..., :3, 3]
    new_center = jnp.einsum("...ij,...j->...i", lin, center, precision="highest") + t
    new_extent = jnp.einsum("...ij,...j->...i", jnp.abs(lin), extent, precision="highest")
    return new_center - new_extent, new_center + new_extent
