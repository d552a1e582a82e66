"""Unit tests for renderer_jax.mathx vs numpy references."""

import jax.numpy as jnp
import numpy as np
import pytest

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera, camera_matrices, perspective


def np_quat_to_mat3(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def test_quat_identity_rotation():
    q = mathx.quat_identity()
    v = jnp.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(mathx.quat_rotate(q, v), v, atol=1e-6)


def test_quat_axis_angle_matches_rodrigues():
    rng = np.random.default_rng(0)
    for _ in range(5):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(-np.pi, np.pi)
        v = rng.normal(size=3)
        q = mathx.quat_from_axis_angle(axis, angle)
        got = np.asarray(mathx.quat_rotate(q, jnp.asarray(v, jnp.float32)))
        # Rodrigues formula
        k = axis
        expect = (
            v * np.cos(angle)
            + np.cross(k, v) * np.sin(angle)
            + k * (k @ v) * (1 - np.cos(angle))
        )
        np.testing.assert_allclose(got, expect, atol=1e-5)


def test_quat_mul_composition():
    qa = mathx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.7)
    qb = mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -0.4)
    v = jnp.array([0.3, -1.2, 2.0])
    via_mul = mathx.quat_rotate(mathx.quat_mul(qa, qb), v)
    sequential = mathx.quat_rotate(qa, mathx.quat_rotate(qb, v))
    np.testing.assert_allclose(via_mul, sequential, atol=1e-5)


def test_trs_matrix_components():
    t = jnp.array([1.0, 2.0, 3.0])
    q = mathx.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), np.pi / 2)
    s = jnp.float32(2.0)
    m = mathx.trs_matrix(t, q, s)
    # origin maps to translation
    p = mathx.transform_points(m, jnp.zeros((1, 3)))
    np.testing.assert_allclose(p[0], t, atol=1e-6)
    # +X scaled by 2 then rotated 90deg about z -> +2Y, plus translation
    p = mathx.transform_points(m, jnp.array([[1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(p[0], [1.0, 4.0, 3.0], atol=1e-5)


def test_trs_matrix_batched():
    n = 7
    rng = np.random.default_rng(1)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    axis = rng.normal(size=(n, 3))
    angle = rng.uniform(-3, 3, size=n)
    q = mathx.quat_from_axis_angle(jnp.asarray(axis, jnp.float32), jnp.asarray(angle, jnp.float32))
    s = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    m = mathx.compose_model_matrices(jnp.asarray(t), q, jnp.asarray(s))
    assert m.shape == (n, 4, 4)
    for i in range(n):
        mi = mathx.trs_matrix(jnp.asarray(t[i]), q[i], jnp.float32(s[i]))
        np.testing.assert_allclose(m[i], mi, atol=1e-6)


def test_transform_aabb_conservative_and_tight():
    rng = np.random.default_rng(2)
    mn = np.array([-1.0, -2.0, -0.5], np.float32)
    mx = np.array([1.0, 0.5, 2.0], np.float32)
    q = mathx.quat_from_axis_angle(jnp.array([0.3, 0.8, 0.1]), 1.1)
    m = mathx.trs_matrix(jnp.array([3.0, -1.0, 2.0]), q, jnp.float32(1.5))
    out_min, out_max = mathx.transform_aabb(m, jnp.asarray(mn), jnp.asarray(mx))
    # brute force: transform the 8 corners
    corners = np.array(
        [[x, y, z] for x in (mn[0], mx[0]) for y in (mn[1], mx[1]) for z in (mn[2], mx[2])],
        np.float32,
    )
    tc = np.asarray(mathx.transform_points(m, jnp.asarray(corners)))
    np.testing.assert_allclose(out_min, tc.min(axis=0), atol=1e-4)
    np.testing.assert_allclose(out_max, tc.max(axis=0), atol=1e-4)


def test_perspective_depth_range():
    p = perspective(1.0, 1.0, near=0.1, far=100.0)
    for z, expect in [(-0.1, 0.0), (-100.0, 1.0)]:
        clip = p @ jnp.array([0.0, 0.0, z, 1.0])
        ndc_z = clip[2] / clip[3]
        np.testing.assert_allclose(ndc_z, expect, atol=1e-5)


def test_view_matrix_look_at_equivalence():
    cam = Camera.create(position=jnp.array([0.0, 0.0, 5.0]))
    v = mathx.view_matrix(cam)
    la = mathx.look_at(jnp.array([0.0, 0.0, 5.0]), jnp.array([0.0, 0.0, 0.0]))
    np.testing.assert_allclose(v, la, atol=1e-6)


def test_frustum_culling():
    cam = Camera.create(position=jnp.array([0.0, 0.0, 5.0]), fov_y=1.0, near=0.1, far=50.0)
    _, _, vp = camera_matrices(cam)
    planes = mathx.frustum_planes(vp)
    centers = jnp.array(
        [
            [0.0, 0.0, 0.0],    # dead ahead: visible
            [0.0, 0.0, 100.0],  # behind camera: culled
            [0.0, 0.0, -80.0],  # beyond far: culled
            [60.0, 0.0, 0.0],   # far right: culled
            [3.0, 0.0, 0.0],    # near edge w/ big extent: visible
        ]
    )
    extents = jnp.array(
        [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [3.0, 3.0, 3.0]]
    )
    culled = np.asarray(mathx.aabb_outside_frustum(planes, centers, extents))
    np.testing.assert_array_equal(culled, [False, True, True, True, False])


def test_frustum_never_culls_visible_points():
    """Property: points strictly inside the frustum are never culled."""
    rng = np.random.default_rng(3)
    cam = Camera.create(position=jnp.array([1.0, 2.0, 8.0]), fov_y=0.9, aspect=1.5)
    _, _, vp = camera_matrices(cam)
    planes = mathx.frustum_planes(vp)
    vp_np = np.asarray(vp)
    pts = rng.uniform(-20, 20, size=(500, 3)).astype(np.float32)
    h = np.concatenate([pts, np.ones((500, 1), np.float32)], axis=1)
    clip = h @ vp_np.T
    w = clip[:, 3]
    ndc = clip[:, :3] / w[:, None]
    inside = (
        (w > 0)
        & (np.abs(ndc[:, 0]) < 0.99)
        & (np.abs(ndc[:, 1]) < 0.99)
        & (ndc[:, 2] > 0.001)
        & (ndc[:, 2] < 0.999)
    )
    culled = np.asarray(
        mathx.aabb_outside_frustum(planes, jnp.asarray(pts), jnp.zeros((500, 3)))
    )
    assert not np.any(culled & inside), "culled a visible point"
