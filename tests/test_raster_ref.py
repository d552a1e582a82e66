"""Tests pinning down the rasterization spec via the numpy reference."""

import numpy as np

import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera, camera_matrices
from renderer_jax.ops.raster_ref import rasterize_ref, interpolate
from renderer_jax.ops.raster_spec import NO_TRIANGLE
from renderer_jax.scene import primitives


def ndc_tri(v0, v1, v2, z=0.5):
    """Clip positions (w=1) from 2D NDC coords, CCW = front."""
    pts = np.array([v0, v1, v2], np.float64)
    return np.concatenate(
        [pts, np.full((3, 1), z), np.ones((3, 1))], axis=1
    )


def test_single_triangle_coverage_and_bary():
    clip = ndc_tri([-0.8, -0.8], [0.8, -0.8], [0.0, 0.8])
    out = rasterize_ref(clip, np.array([[0, 1, 2]]), 64, 64)
    n = (out.tri_id == 0).sum()
    # triangle area in NDC = 0.5*1.6*1.6 -> fraction of screen = 0.32
    assert abs(n / (64 * 64) - 0.32) < 0.03
    covered = out.tri_id == 0
    s = out.bary[covered].sum(axis=-1)
    np.testing.assert_allclose(s, 1.0, atol=1e-6)
    assert np.all(out.depth[covered] == np.float32(0.5))
    assert np.all(out.depth[~covered] == 1.0)


def test_interpolation_linear_gradient():
    """Attribute = NDC x should reproduce each pixel's NDC x (affine, w=1)."""
    clip = np.array(
        [[-1, -1, 0.5, 1], [3, -1, 0.5, 1], [-1, 3, 0.5, 1]], np.float64
    )  # covers the whole screen
    out = rasterize_ref(clip, np.array([[0, 1, 2]]), 32, 32)
    assert np.all(out.tri_id == 0)
    img = interpolate(out, np.array([[0, 1, 2]]), clip[:, 0:1])
    j = np.arange(32)
    expect_x = (j + 0.5) / 32 * 2 - 1
    np.testing.assert_allclose(img[:, :, 0], np.broadcast_to(expect_x, (32, 32)), atol=1e-5)


def test_watertight_shared_edge():
    """Quad split along the diagonal: every pixel claimed exactly once."""
    quad = np.array(
        [[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64
    )
    clip = np.concatenate(
        [quad, np.full((4, 1), 0.5), np.ones((4, 1))], axis=1
    )
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    out = rasterize_ref(clip, tris, 64, 64)
    # full coverage, no holes
    assert np.all(out.tri_id != NO_TRIANGLE)
    # each triangle individually: coverage counts add up exactly (no overlap)
    c0 = (rasterize_ref(clip, tris[:1], 64, 64).tri_id == 0).sum()
    out1 = rasterize_ref(clip, tris[1:], 64, 64)
    c1 = (out1.tri_id == 0).sum()
    assert c0 + c1 == 64 * 64


def test_depth_ordering_and_tie_break():
    t_far = ndc_tri([-1, -1], [1, -1], [0, 1], z=0.8)
    t_near = ndc_tri([-1, -1], [1, -1], [0, 1], z=0.2)
    clip = np.concatenate([t_far, t_near], axis=0)
    tris = np.array([[0, 1, 2], [3, 4, 5]])
    out = rasterize_ref(clip, tris, 32, 32)
    covered = out.tri_id != NO_TRIANGLE
    assert np.all(out.tri_id[covered] == 1)
    # same depth: lower id wins
    t_same = ndc_tri([-1, -1], [1, -1], [0, 1], z=0.2)
    clip2 = np.concatenate([t_same, t_same], axis=0)
    out2 = rasterize_ref(clip2, tris, 32, 32)
    covered2 = out2.tri_id != NO_TRIANGLE
    assert np.all(out2.tri_id[covered2] == 0)


def test_backface_culling():
    cw = ndc_tri([-0.8, -0.8], [0.0, 0.8], [0.8, -0.8])  # clockwise = back
    out = rasterize_ref(cw, np.array([[0, 1, 2]]), 32, 32)
    assert np.all(out.tri_id == NO_TRIANGLE)
    out2 = rasterize_ref(cw, np.array([[0, 1, 2]]), 32, 32, cull_backface=False)
    assert (out2.tri_id == 0).sum() > 0


def test_behind_camera_rejected():
    tri = ndc_tri([-0.8, -0.8], [0.8, -0.8], [0.0, 0.8], z=0.5)
    tri[:, 3] = -1.0  # all w negative: behind the camera
    out = rasterize_ref(tri, np.array([[0, 1, 2]]), 32, 32, cull_backface=False)
    assert np.all(out.tri_id == NO_TRIANGLE)


def test_near_plane_crossing_no_nan():
    """One vertex behind the camera: clipless raster renders the front part."""
    cam = Camera.create(position=jnp.array([0.0, 0.0, 2.0]), near=0.1, far=10.0)
    _, _, vp = camera_matrices(cam)
    vp = np.asarray(vp, np.float64)
    verts = np.array(
        [[-1.0, -0.5, 0.0], [1.0, -0.5, 0.0], [0.0, 0.5, 5.0]], np.float64
    )  # third vertex is behind the camera (z=5 > cam z=2)
    h = np.concatenate([verts, np.ones((3, 1))], axis=1)
    clip = h @ vp.T
    assert clip[2, 3] < 0  # confirm setup
    out = rasterize_ref(clip, np.array([[0, 1, 2]]), 64, 64, cull_backface=False)
    n = (out.tri_id == 0).sum()
    assert n > 0, "front part of near-crossing triangle must be visible"
    assert np.isfinite(out.depth).all()
    zc = out.depth[out.tri_id == 0]
    assert np.all((zc >= 0) & (zc <= 1))


def test_front_sign_box_through_camera():
    """Camera at +Z looking at a box: the face we see is +Z (normal (0,0,1)),
    and backface culling must not remove it (pins FRONT_DET_SIGN)."""
    mesh = primitives.box()
    cam = Camera.create(position=jnp.array([0.0, 0.0, 3.0]), near=0.1, far=10.0)
    _, _, vp = camera_matrices(cam)
    vp = np.asarray(vp, np.float64)
    h = np.concatenate([mesh.positions, np.ones((len(mesh.positions), 1))], axis=1)
    clip = h @ vp.T
    out = rasterize_ref(clip, mesh.indices, 64, 64)
    center_tri = out.tri_id[32, 32]
    assert center_tri != NO_TRIANGLE, "box front face was culled: FRONT_DET_SIGN wrong"
    # the visible face's normal points toward the camera (+Z)
    n = mesh.normals[mesh.indices[center_tri][0]]
    np.testing.assert_allclose(n, [0, 0, 1], atol=1e-6)
    # exactly half the faces are front-facing; total coverage is the box silhouette
    assert (out.tri_id != NO_TRIANGLE).sum() > 0.05 * 64 * 64


def test_degenerate_triangle_skipped():
    clip = ndc_tri([0.0, 0.0], [0.0, 0.0], [0.5, 0.5])
    out = rasterize_ref(clip, np.array([[0, 1, 2]]), 16, 16, cull_backface=False)
    assert np.all(out.tri_id == NO_TRIANGLE)


def test_tri_valid_mask():
    clip = np.concatenate(
        [ndc_tri([-1, -1], [1, -1], [0, 1], z=0.2), ndc_tri([-1, -1], [1, -1], [0, 1], z=0.8)],
        axis=0,
    )
    tris = np.array([[0, 1, 2], [3, 4, 5]])
    out = rasterize_ref(clip, tris, 16, 16, tri_valid=np.array([False, True]))
    covered = out.tri_id != NO_TRIANGLE
    assert np.all(out.tri_id[covered] == 1)
