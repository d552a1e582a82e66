"""Streaming, HUD, profiling-stats, crash-forensics tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from renderer_jax.mathx.camera import Camera
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.runtime.hud import format_hud, validate_frame
from renderer_jax.runtime.streaming import SceneStreamer
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives
from renderer_jax.utils.profiling import FrameStats


def base_scene():
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material(base_color=(0.7, 0.7, 0.7, 1))
    b.add_instance(box, m)
    b.add_light(position=(2, 3, 4), intensity=20.0)
    return b.build()


def cam():
    return Camera.create(position=jnp.array([0.0, 0.8, 4.0]), near=0.1, far=50.0)


def test_streaming_budget_and_render():
    scene = base_scene()
    streamer = SceneStreamer(scene, budget=3)
    for i in range(7):
        streamer.request_mesh(
            primitives.uv_sphere(rings=4, sectors=6),
            material_id=0,
            translation=(i - 3.0, 0.0, -1.0),
            scale=0.4,
        )
    # wait for decodes, then pump respecting the budget
    import time

    for _ in range(50):
        time.sleep(0.02)
        if all(f.done() for f in streamer._pending):
            break
    s1 = streamer.pump()
    assert streamer.stats["uploaded"] == 3
    s2 = streamer.pump()
    assert streamer.stats["uploaded"] == 6
    s3 = streamer.pump()
    assert streamer.stats["uploaded"] == 7
    assert int(s3.meshes.mesh_count) == 8  # 1 + 7 streamed
    assert int(s3.instances.count) == 8

    # the streamed-in content actually renders
    r = Renderer(s3, PipelineConfig(width=64, height=64, tri_capacity=1024))
    out = r.render(cam())
    cov = (np.asarray(out["vis"].tri_id) != -1).mean()
    assert cov > 0.05
    streamer.close()


def test_streaming_large_mesh_chunked():
    """Meshes beyond CHUNK_VERTS stream by looping the fixed-shape donated
    chunk program (ref: scene_loader.rs streams arbitrary glTFs)."""
    from renderer_jax.runtime.allocator import Arena
    from renderer_jax.runtime.streaming import CHUNK_VERTS

    b = SceneBuilder(SceneLimits.tiny()._replace(max_vertices=16384, max_triangles=16384))
    box = b.add_mesh(primitives.box())
    m = b.add_material(base_color=(0.7, 0.7, 0.7, 1))
    b.add_instance(box, m)
    b.add_light(position=(2, 3, 4), intensity=20.0)
    scene = b.build()
    arena = Arena(16 << 20)
    streamer = SceneStreamer(scene, budget=8, arena=arena)
    big = primitives.uv_sphere(rings=64, sectors=96)  # > CHUNK_VERTS
    n_v, n_t = len(big.positions), len(big.indices)
    assert n_v > CHUNK_VERTS
    streamer.request_mesh(big, translation=(0, 0, -1.0), scale=0.8)
    import time

    for _ in range(100):
        time.sleep(0.02)
        if all(f.done() for f in streamer._pending):
            break
    s = streamer.pump()
    assert streamer.stats["uploaded"] == 1
    assert streamer.stats["chunks"] >= 2  # actually chunked
    lib = s.meshes
    assert int(lib.mesh_vertex_count[1]) == n_v
    assert int(lib.lod_tri_count[1, 0]) == n_t
    # round-trip: the chunked upload preserved the vertex data exactly
    off = int(lib.mesh_vertex_offset[1])
    np.testing.assert_array_equal(
        np.asarray(lib.positions[off:off + n_v]), big.positions
    )
    # arena staging is live, frees deferred two pumps
    assert arena.stats()["live_allocs"] > 0
    streamer.pump(); streamer.pump()
    assert arena.stats()["live_allocs"] == 0

    # the streamed sphere renders
    r = Renderer(s, PipelineConfig(width=64, height=64, tri_capacity=8192))
    out = r.render(cam())
    cov = (np.asarray(out["vis"].tri_id) != -1).mean()
    assert cov > 0.05
    streamer.close()
    arena.close()


def test_streaming_capacity_guard():
    """Exhausting the mesh library raises MemoryError (not silent clamping)."""
    scene = base_scene()
    streamer = SceneStreamer(scene, budget=8)
    v_cap = scene.meshes.positions.shape[0]
    n = 0
    with pytest.raises(MemoryError, match="capacity exhausted"):
        while True:
            streamer._upload(
                primitives.uv_sphere(rings=12, sectors=16), 0, (0, 0, 0),
                (1, 0, 0, 0), 1.0,
            )
            n += 1
            assert n < 10_000
    assert streamer._v_off <= v_cap
    streamer.close()


def test_hud_contents():
    from renderer_jax.runtime.allocator import Arena

    scene = base_scene()
    r = Renderer(scene, PipelineConfig(width=64, height=64, tri_capacity=256))
    r.render(cam())
    fs = FrameStats()
    fs.tick(); fs.tick()
    arena = Arena(1 << 16)
    x = arena.alloc((100,), np.float32)
    hud = format_hud(r, frame_stats=fs, arena=arena, extra={"coverage": "42%"})
    assert "frame 2" in hud
    assert "active passes" in hud and "raster" in hud
    assert "staging arena" in hud and "live allocs 1" in hud
    assert "coverage: 42%" in hud
    assert "freeze_culling=off" in hud
    arena.free(x); arena.close()


def test_validate_frame_catches_nan(tmp_path):
    good = {"image": jnp.ones((4, 4, 3))}
    validate_frame(good)  # no raise
    bad = {"image": jnp.array([[jnp.nan]])}
    dump = str(tmp_path / "crash.npz")
    with pytest.raises(FloatingPointError, match="non-finite"):
        validate_frame(bad, dump_path=dump)
    import os

    assert os.path.exists(dump)


def test_frame_stats():
    fs = FrameStats(window=4)
    import time

    for _ in range(6):
        fs.tick()
        time.sleep(0.001)
    s = fs.summary()
    assert s["fps"] > 0 and s["ms_avg"] > 0
    assert len(fs.samples) <= 4


def test_projectile_churn():
    """Spawn/despawn churn (the reference's projectiles + Deleting path)."""
    from renderer_jax.runtime.gameplay import ProjectileSystem

    scene = base_scene()
    ps = ProjectileSystem(scene, mesh_id=0, material_id=0, capacity=8)
    # spawn one per tick; ttl 0.1s at dt=1/60 -> ~6 ticks lifetime
    for _ in range(5):
        ps.step(dt=1 / 60, ttl=0.1)
    assert ps.alive_count() == 5
    # stop spawning; all expire
    for _ in range(10):
        ps.step(dt=1 / 60, ttl=0.1, spawn=False)
    assert ps.alive_count() == 0
    # steady state with spawning: capacity-bounded
    for _ in range(40):
        ps.step(dt=1 / 60, ttl=0.1)
    assert 0 < ps.alive_count() <= 8

    # churned scene still renders (alive mask respected by culling)
    r = Renderer(ps.scene, PipelineConfig(width=64, height=64, tri_capacity=1024))
    out = r.render(cam())
    assert np.isfinite(np.asarray(out["image"])).all()


def test_camera_controller():
    """Fly/walk camera math (parity with ecs/camera_controller.rs)."""
    from renderer_jax.runtime.camera_controller import CameraState, InputFrame, step, to_camera

    s = CameraState(position=np.zeros(3, np.float32))
    # looking -Z by default: W moves toward -Z
    s2 = step(s, InputFrame(forward=1.0, speed=2.0), dt=0.5)
    np.testing.assert_allclose(s2.position, [0, 0, -1.0], atol=1e-6)
    # yaw 90deg left (look_dx negative = turn left? our convention: yaw -= dx)
    s3 = step(s2, InputFrame(look_dx=-np.pi / 2), dt=0.1)
    s4 = step(s3, InputFrame(forward=1.0, speed=1.0), dt=1.0)
    # now facing -X... yaw=+pi/2: forward = (-sin(yaw), 0, -cos(yaw)) = (-1, 0, 0)
    np.testing.assert_allclose(s4.position - s3.position, [-1, 0, 0], atol=1e-5)
    # pitch clamp
    s5 = step(s4, InputFrame(look_dy=-10.0), dt=0.1)
    assert abs(s5.pitch) <= 1.55
    # walk mode pins height
    s5.fly_mode = False
    s5.ground_y = 0.0
    s5.pitch = -1.0
    s6 = step(s5, InputFrame(forward=1.0, speed=1.0), dt=1.0)
    assert s6.position[1] == 0.0
    np.testing.assert_allclose(np.linalg.norm(s6.position - s5.position * [1, 0, 1]), 1.0, atol=1e-4)
    # produces a renderable camera
    cam = to_camera(s6)
    assert cam.position.shape == (3,)


def test_camera_controller_drives_renderer():
    from renderer_jax.runtime.camera_controller import CameraState, InputFrame, step, to_camera

    scene = base_scene()
    r = Renderer(scene, PipelineConfig(width=64, height=64, tri_capacity=256))
    s = CameraState(position=np.array([0.0, 0.5, 4.0], np.float32))
    imgs = []
    for _ in range(3):
        s = step(s, InputFrame(forward=1.0, speed=6.0), dt=1 / 30)
        imgs.append(np.asarray(r.render(to_camera(s))["image"]))
    # moving toward the box changes the frame
    assert np.abs(imgs[2] - imgs[0]).max() > 0.02


def test_texture_streaming():
    """Textures stream into preallocated atlas slots and take effect."""
    import time

    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    b = SceneBuilder(SceneLimits.tiny(), atlas_size=8)
    pl = b.add_mesh(primitives.plane(size=8.0))
    # material points at layer 0, which starts as a white placeholder
    m = b.add_material(base_color=(1, 1, 1, 1), roughness=1.0, base_color_tex=0)
    b.add_instance(pl, m)
    b.add_light(position=(0, -1, 0), directional=True, intensity=3.0)
    scene = b.build(texture_slots=2)

    import jax.numpy as jnp

    from renderer_jax import mathx
    from renderer_jax.mathx.camera import Camera

    cam = Camera.create(
        position=jnp.array([0.0, 2.0, 0.0]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        near=0.1, far=50.0,
    )
    streamer = SceneStreamer(scene, budget=2)
    cfg = PipelineConfig(width=32, height=32, tri_capacity=128)
    r = Renderer(streamer.scene, cfg)
    before = np.asarray(r.render(cam, scene=streamer.scene)["image"])[16, 16]

    red = np.zeros((8, 8, 4), np.uint8)
    red[..., 0] = 255
    red[..., 3] = 255
    layer = streamer.request_texture(red)
    assert layer == 0 or layer >= 0
    for _ in range(100):
        time.sleep(0.02)
        if all(f.done() for f in streamer._pending):
            break
    streamer.pump()
    after = np.asarray(r.render(cam, scene=streamer.scene)["image"])[16, 16]
    # white placeholder -> red texture
    assert before[1] > 0.1 and abs(before[0] - before[1]) < 0.05
    assert after[0] > 0.1 and after[1] < 0.05 * after[0] + 0.02, (before, after)
    streamer.close()


def test_kernel_live_reload(tmp_path):
    """Editing a watched kernel module changes the next frame's output
    without a process restart; a broken edit keeps the old graph rendering
    (ref: shader_reload.rs keep-old-pipeline semantics)."""
    import os
    import sys
    import textwrap
    import time as _time

    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.runtime.reload import KernelReloader

    mod_path = tmp_path / "hot_shade.py"
    mod_path.write_text("TINT = 0.0\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import hot_shade  # noqa: F401

        from renderer_jax.graph import FrameGraph

        def build_graph():
            import hot_shade as hs

            g = FrameGraph("hot")
            g.resource("camera", external=True)
            g.resource("scene", external=True)
            g.resource("time", external=True)
            g.resource("image")

            @g.pass_("shade", reads=["camera"], writes=["image"])
            def shade(camera):
                return {"image": jnp.full((4, 4, 3), hs.TINT, jnp.float32)}

            return g

        from renderer_jax.models import box_scene
        from renderer_jax.runtime import Renderer
        from renderer_jax.scene import SceneLimits

        scene = box_scene(SceneLimits.tiny())
        r = Renderer(scene, graph=build_graph(), outputs=("image",))
        reloader = KernelReloader(r, rebuild=build_graph, modules=["hot_shade"])
        cam = Camera.create(position=jnp.array([0.0, 0.0, 3.0]))

        img0 = np.asarray(r.render(cam)["image"])
        assert img0.max() == 0.0

        _time.sleep(0.01)
        mod_path.write_text("TINT = 0.5\n")
        os.utime(mod_path)  # ensure mtime moves even on coarse filesystems
        assert reloader.poll() is True
        img1 = np.asarray(r.render(cam)["image"])
        np.testing.assert_allclose(img1, 0.5)
        assert reloader.stats["reloads"] == 1

        # broken edit: old graph keeps rendering, failure recorded
        _time.sleep(0.01)
        mod_path.write_text("TINT = (unclosed\n")
        os.utime(mod_path)
        assert reloader.poll() is False
        assert reloader.stats["failures"] == 1
        img2 = np.asarray(r.render(cam)["image"])
        np.testing.assert_allclose(img2, 0.5)
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("hot_shade", None)


def test_pass_timings_diagnostic():
    """pass_timings times every live pass individually and feeds the HUD
    (the reference's per-system GPU timestamp panel, ecs.rs:293-409)."""
    scene = base_scene()
    r = Renderer(scene, PipelineConfig(width=64, height=64, tri_capacity=256))
    out = r.render(cam())
    timings = r.pass_timings(cam(), iters=2)
    plan = r.plans.plan(r.config.as_dict())
    assert set(timings) == {p.name for p in plan.passes}
    assert all(v >= 0.0 for v in timings.values())
    hud = format_hud(r)
    assert "pass timings" in hud and "SUM (unfused)" in hud
    # diagnostic mode must not disturb the frame state: next render unchanged
    out2 = r.render(cam())
    assert np.asarray(out2["image"]).shape == np.asarray(out["image"]).shape


def test_hud_capacity_overflow_counters():
    """Caster truncation and cluster-budget overflow surface in the HUD
    (silent capacity clamps otherwise show up only as missing geometry)."""
    import jax.numpy as jnp

    from renderer_jax.ops import geometry
    from renderer_jax.ops.shadow import light_matrices_cube, shadow_caster_truncation
    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    b = SceneBuilder(SceneLimits.tiny())
    sph = b.add_mesh(primitives.uv_sphere(rings=8, sectors=12))
    m = b.add_material()
    for i in range(4):
        b.add_instance(sph, m, translation=(i * 2.0 - 3.0, 0, 0))
    b.add_light(position=(0.0, -1.0, 0.0), directional=True, shadow_slot=0)
    scene = b.build()
    prepared = geometry.prepare_frame_columns(scene, cam())
    model, lod = prepared[0], prepared[4]
    mats = light_matrices_cube(scene.lights, prepared[5], prepared[6])

    # plenty of capacity: no truncation; capacity 64: casters dropped
    ok = shadow_caster_truncation(scene, model, lod, mats, 1, 1 << 16)
    assert int(ok[0]) == 0
    bad = shadow_caster_truncation(scene, model, lod, mats, 1, 64)
    assert int(bad[0]) > 0

    vis = jnp.ones((scene.instances.mesh_id.shape[0],), bool)
    assert int(geometry.cluster_budget_overflow(scene, vis, lod, 1 << 14)) == 0
    assert int(geometry.cluster_budget_overflow(scene, vis, lod, 64)) > 0

    # HUD renders the counters when shadows are on and prepared is passed
    r = Renderer(scene, PipelineConfig(width=64, height=64, tri_capacity=256),
                 outputs=("image", "prepared"))
    r.set_config(shadows=True)
    r.apply_config_now()
    out = r.render(cam())
    hud = format_hud(r, prepared=out["prepared"])
    assert "shadow casters" in hud


def test_texture_layer_recycling():
    """Released streamed-texture layers recycle through a free list, and
    exhaustion raises a clean MemoryError naming the remedy."""
    import time as _t

    from renderer_jax.runtime.streaming import SceneStreamer
    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    b = SceneBuilder(SceneLimits.tiny(), atlas_size=8)
    pl = b.add_mesh(primitives.plane())
    b.add_instance(pl, b.add_material())
    scene = b.build(texture_slots=2)
    s = SceneStreamer(scene, budget=4)
    img = np.zeros((8, 8, 4), np.uint8)
    l0 = s.request_texture(img)
    l1 = s.request_texture(img)
    assert l0 != l1
    with pytest.raises(MemoryError, match="release_texture"):
        s.request_texture(img)
    s.release_texture(l0)
    assert s.request_texture(img) == l0  # recycled
    with pytest.raises(ValueError):
        s.release_texture(999)
    s.close()


def test_auto_capacity_ladder():
    """AutoCapacityRenderer: the capacity tier grows
    until the culled count fits with headroom — no operator-set
    tri_capacity — and shrinks (with hysteresis) when the camera sees
    little; persistent state carries across tier switches."""
    import dataclasses as _dc

    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.models import sponza_like_scene
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import AutoCapacityRenderer

    scene = sponza_like_scene(300, area=20.0)
    cfg = PipelineConfig(width=64, height=64, shading="pbr")
    r = AutoCapacityRenderer(
        scene, cfg, ladder=(512, 2048, 8192, 32768), check_every=1,
    )
    cam = Camera.create(
        position=jnp.array([0.0, 3.0, 14.0]), fov_y=1.0, near=0.1, far=100.0
    )
    assert r.capacity == 512
    for _ in range(6):
        out = r.render(cam)
    demand = r.stats["last_demand"]
    assert demand < 2 * r.capacity * r.up_frac, (demand, r.capacity)
    assert r.capacity > 512, "dense view must climb the ladder"
    assert np.isfinite(np.asarray(out["image"])).all()
    up_tier = r.capacity

    # empty view: far away looking at nothing -> descend (hysteresis:
    # one tier per check)
    cam_empty = Camera.create(
        position=jnp.array([0.0, 500.0, 0.0]), fov_y=0.4, near=0.1, far=10.0
    )
    for _ in range(8):
        r.render(cam_empty)
    assert r.capacity < up_tier, "empty view must descend the ladder"
