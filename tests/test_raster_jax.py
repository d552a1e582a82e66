"""Golden tests: the JAX rasterizer must match the numpy reference."""

import numpy as np
import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera, camera_matrices
from renderer_jax.ops import geometry
from renderer_jax.ops.raster_jax import rasterize, interpolate
from renderer_jax.ops.raster_ref import rasterize_ref
from renderer_jax.ops.raster_spec import NO_TRIANGLE
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives


def soup_from_mesh(mesh, viewproj):
    """(T, 3, 4) clip positions of every mesh triangle (padded to 128)."""
    h = np.concatenate([mesh.positions, np.ones((len(mesh.positions), 1))], axis=1)
    clip = (h @ np.asarray(viewproj).T)[mesh.indices]  # (T, 3, 4)
    t = len(clip)
    pad = (-t) % 128
    clip = np.concatenate([clip, np.zeros((pad, 3, 4))], axis=0).astype(np.float32)
    valid = np.concatenate([np.ones(t, bool), np.zeros(pad, bool)])
    return jnp.asarray(clip), jnp.asarray(valid), t


def compare_vs_ref(mesh, cam, size=128, cull_backface=True, budget=0.005):
    _, _, vp = camera_matrices(cam)
    clip, valid, t = soup_from_mesh(mesh, vp)
    vis = rasterize(clip, valid, size, size, strip_rows=32, cull_backface=cull_backface)
    ref = rasterize_ref(
        np.concatenate(
            [mesh.positions, np.ones((len(mesh.positions), 1))], axis=1
        ) @ np.asarray(vp, np.float64).T,
        mesh.indices,
        size,
        size,
        cull_backface=cull_backface,
    )
    got_id = np.asarray(vis.tri_id)
    mismatch = got_id != ref.tri_id
    frac = mismatch.mean()
    assert frac <= budget, f"tri_id mismatch fraction {frac:.4f} (> {budget})"
    same = ~mismatch & (ref.tri_id != NO_TRIANGLE)
    np.testing.assert_allclose(
        np.asarray(vis.depth)[same], ref.depth[same], atol=2e-4
    )
    # f32 vs f64 differ most near sliver-triangle edges; sub-pixel effect.
    # vis.bary is channel-first (3, H, W); ref.bary is (H, W, 3)
    np.testing.assert_allclose(
        np.moveaxis(np.asarray(vis.bary), 0, -1)[same], ref.bary[same], atol=1e-2
    )
    return vis, ref


def test_box_matches_reference():
    cam = Camera.create(position=jnp.array([1.5, 1.2, 2.5]), near=0.1, far=20.0)
    cam = cam._replace(rotation=mathx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.5))
    vis, ref = compare_vs_ref(primitives.box(), cam)
    assert (np.asarray(vis.tri_id) != NO_TRIANGLE).sum() > 100


def test_sphere_matches_reference():
    cam = Camera.create(position=jnp.array([0.0, 0.5, 2.0]), near=0.1, far=20.0)
    compare_vs_ref(primitives.uv_sphere(rings=12, sectors=18), cam)


def test_torus_two_sided_matches_reference():
    cam = Camera.create(position=jnp.array([0.0, 1.0, 2.2]), near=0.1, far=20.0)
    cam = cam._replace(rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -0.4))
    compare_vs_ref(primitives.torus(), cam, cull_backface=False)


def test_near_crossing_matches_reference():
    """Camera inside a large box: every face crosses the near plane."""
    cam = Camera.create(position=jnp.array([0.1, 0.0, 0.2]), near=0.05, far=50.0)
    compare_vs_ref(primitives.box(size=4.0), cam, cull_backface=False, budget=0.01)


def test_interpolate_matches_reference():
    mesh = primitives.uv_sphere(rings=8, sectors=12)
    cam = Camera.create(position=jnp.array([0.0, 0.0, 2.0]), near=0.1, far=20.0)
    _, _, vp = camera_matrices(cam)
    clip, valid, t = soup_from_mesh(mesh, vp)
    vis = rasterize(clip, valid, 64, 64, strip_rows=32)
    # interpolate uvs: (T, 3, 2) corner attrs
    uv_corner = mesh.uvs[mesh.indices]  # (T, 3, 2)
    pad = np.zeros((clip.shape[0] - t, 3, 2), np.float32)
    uv_img = interpolate(vis, jnp.asarray(np.concatenate([uv_corner, pad])))
    got = np.moveaxis(np.asarray(uv_img), 0, -1)  # (C,H,W) -> (H,W,C)
    covered = np.asarray(vis.tri_id) != NO_TRIANGLE
    assert covered.sum() > 200
    assert np.all(got[covered] >= -1e-4) and np.all(got[covered] <= 1 + 1e-4)
    assert np.all(got[~covered] == 0)
