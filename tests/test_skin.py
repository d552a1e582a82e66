"""Skinning + animation tests (LBS vs numpy, clip sampling, end-to-end)."""

import numpy as np
import jax.numpy as jnp

from renderer_jax.models.scenes import make_skinned_arm, skinned_scene
from renderer_jax.ops.skin import pose_scene, sample_clips


def test_rest_pose_is_identity():
    """At rest (bind pose keys), palettes are identity and geometry is
    unchanged."""
    scene = skinned_scene()
    pal = np.asarray(sample_clips(scene.skins, 0.0))
    # skin 0, joint 0 has no rotation at t=0; its palette must be ~identity
    np.testing.assert_allclose(pal[0, 0], np.eye(4), atol=1e-5)


def test_lbs_matches_numpy():
    """pose_scene must equal a straightforward numpy LBS."""
    scene = skinned_scene()
    t = 0.37
    posed = pose_scene(scene, t)
    pal = np.asarray(sample_clips(scene.skins, t))  # (S, J, 4, 4)
    sk = scene.skins
    vskin = np.asarray(sk.vertex_skin)
    sel = vskin >= 0
    jids = np.asarray(sk.joints)[sel]
    wts = np.asarray(sk.weights)[sel]
    pos = np.asarray(scene.meshes.positions)[sel]
    s = vskin[sel]
    blend = np.einsum("vk,vkij->vij", wts, pal[s[:, None], jids])
    h = np.concatenate([pos, np.ones((len(pos), 1))], axis=1)
    expect = np.einsum("vij,vj->vi", blend, h)[:, :3]
    got = np.asarray(posed.meshes.positions)[sel]
    np.testing.assert_allclose(got, expect, atol=1e-4)
    # rigid vertices untouched
    rigid = ~sel & (np.arange(len(vskin)) < int(scene.meshes.vertex_count))
    np.testing.assert_array_equal(
        np.asarray(posed.meshes.positions)[rigid],
        np.asarray(scene.meshes.positions)[rigid],
    )


def test_animation_moves_vertices():
    scene = skinned_scene()
    p0 = np.asarray(pose_scene(scene, 0.0).meshes.positions)
    p1 = np.asarray(pose_scene(scene, 0.25).meshes.positions)
    sel = np.asarray(scene.skins.vertex_skin) >= 0
    moved = np.linalg.norm(p1[sel] - p0[sel], axis=-1)
    assert moved.max() > 0.1, "animation should move the arm tip"
    # base joint is static: vertices near y=0 barely move
    base = sel & (np.asarray(scene.meshes.positions)[:, 1] < 0.05)
    assert np.linalg.norm((p1 - p0)[base], axis=-1).max() < 0.05


def test_clip_looping_and_interpolation():
    scene = skinned_scene()
    pal_a = np.asarray(sample_clips(scene.skins, 0.1))
    pal_b = np.asarray(sample_clips(scene.skins, 1.1))  # duration 1.0 -> loops
    np.testing.assert_allclose(pal_a, pal_b, atol=1e-5)
    # midway between two keys differs from both
    pal_k0 = np.asarray(sample_clips(scene.skins, 0.0))
    pal_mid = np.asarray(sample_clips(scene.skins, 0.0625))
    assert np.abs(pal_mid - pal_k0).max() > 1e-3


def test_skinned_render_end_to_end():
    from renderer_jax.mathx.camera import Camera
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer

    scene = skinned_scene()
    cfg = PipelineConfig(width=64, height=64, tri_capacity=1024, skinning=True)
    r = Renderer(scene, cfg)
    cam = Camera.create(position=jnp.array([0.0, 1.2, 4.0]), near=0.1, far=50.0)
    out0 = r.render(cam, time_s=0.0)
    out1 = r.render(cam, time_s=0.25)
    img0 = np.asarray(out0["image"])
    img1 = np.asarray(out1["image"])
    assert np.isfinite(img0).all() and np.isfinite(img1).all()
    assert (np.asarray(out0["vis"].tri_id) != -1).sum() > 100
    assert np.abs(img1 - img0).max() > 0.05, "animation must change the frame"
    # one compile covers all frames (time is traced, not static)
    assert r.stats["compiles"] == 1


def _one_joint_skin_builder():
    from renderer_jax.scene import SceneBuilder, SceneLimits
    from renderer_jax.scene.builder import HostMesh

    b = SceneBuilder(SceneLimits.tiny())
    mesh = HostMesh(
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        indices=np.array([[0, 1, 2]], np.int32),
    )
    times = np.array([0.0, 1.0], np.float32)
    key_t = np.zeros((2, 1, 3), np.float32)
    key_r = np.tile(np.array([1, 0, 0, 0], np.float32), (2, 1, 1))
    mid = b.add_skinned_mesh(
        mesh,
        joints=np.zeros((3, 4), np.int32),
        weights=np.array([[1, 0, 0, 0]] * 3, np.float32),
        parents=np.array([-1], np.int32),
        inverse_bind=np.eye(4, dtype=np.float32)[None],
        key_times=times,
        key_t=key_t,
        key_r=key_r,
    )
    b.add_instance(mid, b.add_material())
    b.add_light(position=(1, 2, 3), intensity=5.0)
    return b, mid


def test_cubicspline_clip_matches_numpy_hermite():
    """Device CUBICSPLINE sampling == numpy hermite (glTF formula) on a
    translation-animated joint with random tangents."""
    from renderer_jax.ops.skin import sample_clips, set_active_clip

    rng = np.random.default_rng(3)
    b, mid = _one_joint_skin_builder()
    times = np.array([0.0, 0.4, 1.0], np.float32)
    vals = rng.normal(size=(3, 1, 3)).astype(np.float32)
    tin = rng.normal(size=(3, 1, 3)).astype(np.float32)
    tout = rng.normal(size=(3, 1, 3)).astype(np.float32)
    key_r = np.tile(np.array([1, 0, 0, 0], np.float32), (3, 1, 1))
    ci = b.add_skin_clip(
        mid, times, vals, key_r,
        interpolation="CUBICSPLINE",
        key_t_tangents=(tin, tout),
        key_r_tangents=(np.zeros((3, 1, 4), np.float32),) * 2,
        key_s_tangents=(np.zeros((3, 1), np.float32),) * 2,
    )
    scene = b.build()
    scene = set_active_clip(scene, 0, ci)

    def numpy_hermite(t):
        i = np.clip(np.searchsorted(times, t, side="right"), 1, 2)
        t0, t1 = times[i - 1], times[i]
        dt = t1 - t0
        f = (t - t0) / dt
        f2, f3 = f * f, f ** 3
        return (
            (2 * f3 - 3 * f2 + 1) * vals[i - 1, 0]
            + dt * (f3 - 2 * f2 + f) * tout[i - 1, 0]
            + (-2 * f3 + 3 * f2) * vals[i, 0]
            + dt * (f3 - f2) * tin[i, 0]
        )

    for t in (0.1, 0.4, 0.55, 0.93):
        pal = np.asarray(sample_clips(scene.skins, t))[0, 0]  # (4,4)
        np.testing.assert_allclose(pal[:3, 3], numpy_hermite(t), rtol=1e-5, atol=1e-5)


def test_step_interpolation_holds_previous_key():
    from renderer_jax.ops.skin import sample_clips, set_active_clip

    b, mid = _one_joint_skin_builder()
    times = np.array([0.0, 0.5, 1.0], np.float32)
    vals = np.array([[[0, 0, 0]], [[1, 0, 0]], [[5, 0, 0]]], np.float32)
    key_r = np.tile(np.array([1, 0, 0, 0], np.float32), (3, 1, 1))
    ci = b.add_skin_clip(mid, times, vals, key_r, interpolation="STEP")
    scene = set_active_clip(b.build(), 0, ci)
    pal = np.asarray(sample_clips(scene.skins, 0.74))[0, 0]
    np.testing.assert_allclose(pal[:3, 3], [1, 0, 0], atol=1e-6)


def test_multi_clip_runtime_selection():
    """active_clip switches which animation a skin plays (multi-clip)."""
    from renderer_jax.ops.skin import pose_scene, set_active_clip

    b, mid = _one_joint_skin_builder()
    times = np.array([0.0, 1.0], np.float32)
    shift = np.tile(np.array([2.0, 0, 0], np.float32), (2, 1, 1))
    key_r = np.tile(np.array([1, 0, 0, 0], np.float32), (2, 1, 1))
    ci = b.add_skin_clip(mid, times, shift, key_r)
    scene = b.build()

    p0 = np.asarray(pose_scene(scene, 0.25).meshes.positions[:3])
    p1 = np.asarray(pose_scene(set_active_clip(scene, 0, ci), 0.25).meshes.positions[:3])
    np.testing.assert_allclose(p1 - p0, np.tile([2.0, 0, 0], (3, 1)), atol=1e-5)
