"""Camera, projection, and frustum math.

Replaces the reference's camera/projection systems
(src/ecs.rs:66-91 ``project_camera``,
src/ecs/camera_controller.rs) as a jit-friendly dataclass
pytree plus pure functions.

Depth convention: after perspective divide, z in [0, 1] with near -> 0,
far -> 1 (Vulkan-style; matches the reference so frames are comparable).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from renderer_jax.mathx.transforms import quat_to_mat3


class Camera(NamedTuple):
    """Pinhole camera pytree. ``rotation`` is a (w,x,y,z) unit quaternion
    taking view-space axes into world space (camera forward is -Z)."""

    position: jnp.ndarray  # (3,)
    rotation: jnp.ndarray  # (4,)
    fov_y: jnp.ndarray  # radians, scalar
    aspect: jnp.ndarray  # width / height, scalar
    near: jnp.ndarray  # scalar
    far: jnp.ndarray  # scalar

    @staticmethod
    def create(position, rotation=None, fov_y=1.1, aspect=1.0, near=0.1, far=100.0):
        if rotation is None:
            rotation = jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32)
        return Camera(
            position=jnp.asarray(position, jnp.float32),
            rotation=jnp.asarray(rotation, jnp.float32),
            fov_y=jnp.float32(fov_y),
            aspect=jnp.float32(aspect),
            near=jnp.float32(near),
            far=jnp.float32(far),
        )


def view_matrix(cam: Camera) -> jnp.ndarray:
    """World -> view. Inverse of the camera's rigid transform."""
    r = quat_to_mat3(cam.rotation)  # view->world
    rt = r.T  # world->view
    t = -rt @ cam.position
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(rt)
    m = m.at[:3, 3].set(t)
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> jnp.ndarray:
    """World -> view matrix looking from eye at target."""
    eye = jnp.asarray(eye, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    f = target - eye
    f = f / jnp.linalg.norm(f)
    s = jnp.cross(f, up)
    s = s / jnp.linalg.norm(s)
    u = jnp.cross(s, f)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, :3].set(s)
    m = m.at[1, :3].set(u)
    m = m.at[2, :3].set(-f)
    m = m.at[:3, 3].set(jnp.stack([-s @ eye, -u @ eye, f @ eye]))
    return m


def perspective(fov_y, aspect, near, far) -> jnp.ndarray:
    """Perspective projection, view -> clip, depth range [0, 1].

    Right-handed view space (camera forward -Z). After divide:
    z_ndc = far/(far-near) - far*near/((far-near) * -z_view), so
    z_view=-near -> 0 and z_view=-far -> 1.
    """
    f = 1.0 / jnp.tan(jnp.asarray(fov_y, jnp.float32) / 2.0)
    near = jnp.float32(near)
    far = jnp.float32(far)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(f / aspect)
    m = m.at[1, 1].set(f)
    m = m.at[2, 2].set(far / (near - far))
    m = m.at[2, 3].set(near * far / (near - far))
    m = m.at[3, 2].set(-1.0)
    return m


def orthographic(half_w, half_h, near, far) -> jnp.ndarray:
    """Orthographic projection, view -> clip, depth range [0, 1], centered.
    Used by directional shadow cameras (ref: shadow_mapping.rs light MVPs)."""
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(1.0 / half_w)
    m = m.at[1, 1].set(1.0 / half_h)
    m = m.at[2, 2].set(-1.0 / (far - near))
    m = m.at[2, 3].set(-near / (far - near))
    m = m.at[3, 3].set(1.0)
    return m


def camera_matrices(cam: Camera):
    """(view, proj, viewproj) for a Camera. The reference uploads exactly this
    pair into the camera UBO (src/renderer.rs:2290-2308)."""
    v = view_matrix(cam)
    p = perspective(cam.fov_y, cam.aspect, cam.near, cam.far)
    return v, p, p @ v


def frustum_planes(viewproj: jnp.ndarray) -> jnp.ndarray:
    """Extract 6 frustum planes (a,b,c,d with a*x+b*y+c*z+d >= 0 inside) from a
    viewproj matrix, Gribb-Hartmann style. Order: left, right, bottom, top,
    near, far. Mirrors src/ecs.rs:66-91 ``project_camera``.
    Returns (6, 4), normalized."""
    r = viewproj
    planes = jnp.stack(
        [
            r[3] + r[0],  # left:   x >= -w
            r[3] - r[0],  # right:  x <= w
            r[3] + r[1],  # bottom
            r[3] - r[1],  # top
            r[2],         # near:   z >= 0 (VK depth range)
            r[3] - r[2],  # far:    z <= w
        ]
    )
    n = jnp.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
    return planes / n


def aabb_outside_frustum(
    planes: jnp.ndarray, center: jnp.ndarray, extent: jnp.ndarray
) -> jnp.ndarray:
    """Conservative frustum test for batched AABBs in center/extent form.

    Returns (N,) bool, True when certainly outside (safe to cull). This is the
    coarse CPU cull of the reference (cull_pipeline.rs:99-120) as one fused
    vector computation over the whole scene.
    planes: (6,4); center, extent: (N,3).
    """
    # signed distance of the AABB's most-inside corner per plane
    d = center @ planes[:, :3].T + planes[None, :, 3]  # (N, 6)
    r = extent @ jnp.abs(planes[:, :3]).T  # (N, 6)
    return jnp.any(d + r < 0.0, axis=-1)
