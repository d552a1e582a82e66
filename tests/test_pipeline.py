"""Pipeline-as-frame-graph + Renderer runtime tests."""

import numpy as np
import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera
from renderer_jax.ops.raster_spec import NO_TRIANGLE
from renderer_jax.passes.pipeline import PipelineConfig, build_forward_graph
from renderer_jax.runtime import Renderer
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives


def small_scene():
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material(base_color=(0.9, 0.4, 0.2, 1.0))
    b.add_instance(box, m)
    b.add_instance(box, m, translation=(1.5, 0, -1.0), scale=0.5)
    b.add_light(position=(2.0, 3.0, 4.0), intensity=20.0)
    return b.build()


def cam(x=0.0):
    return Camera.create(position=jnp.array([x, 0.5, 3.0]), near=0.1, far=50.0)


# lambert: graph-semantics tests want camera-independent shading so a frozen
# soup renders bit-identically under a moved camera
CFG = PipelineConfig(width=64, height=64, tri_capacity=256, shading="lambert")


def test_renderer_basic_frame():
    r = Renderer(small_scene(), CFG)
    out = r.render(cam())
    img = np.asarray(out["image"])
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    assert (np.asarray(out["vis"].tri_id) != NO_TRIANGLE).sum() > 50
    assert r.frame_number == 2
    assert r.stats["compiles"] == 1


def test_jit_cache_reused_across_frames():
    r = Renderer(small_scene(), CFG)
    for i in range(4):
        out = r.render(cam(0.1 * i))
    assert r.stats["compiles"] == 1
    assert r.stats["frames"] == 4


def test_freeze_culling_freezes_draw_list():
    """freeze_culling pins the culled draw LIST while vertices keep being
    re-transformed by the live camera — the reference's semantics
    (cull_pass_bypass keeps index buffers, the vertex shader uses the live
    MVP; cull_pipeline.rs:331-421)."""
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material(base_color=(0.9, 0.4, 0.2, 1.0))
    b.add_instance(box, m, translation=(0.0, 0.0, 0.0))       # in view
    b.add_instance(box, m, translation=(0.0, 0.0, 100.0))     # behind camera
    b.add_light(position=(2.0, 3.0, 4.0), intensity=20.0)
    scene = b.build()

    behind_cam = Camera.create(position=jnp.array([0.0, 0.0, 103.0]), near=0.1, far=50.0)

    r = Renderer(scene, CFG)
    out1 = r.render(cam())  # normal frame: draw list = front box only
    r.set_config(freeze_culling=True)
    r.render(cam())  # latch frame (still unfrozen)
    # frozen + SAME camera: identical image
    frozen_same = np.asarray(r.render(cam())["image"])
    np.testing.assert_allclose(frozen_same, np.asarray(out1["image"]), atol=1e-6)
    # frozen + camera moved to look at the second box: it was never in the
    # frozen draw list, so nothing of it can appear
    frozen_moved = r.render(behind_cam)
    assert np.all(np.asarray(frozen_moved["vis"].tri_id) == -1)
    # unfrozen, same camera: the second box appears
    r.set_config(freeze_culling=False)
    r.render(behind_cam)  # latch
    live = r.render(behind_cam)
    assert (np.asarray(live["vis"].tri_id) != -1).sum() > 20


def test_debug_aabbs_switch():
    r = Renderer(small_scene(), CFG)
    out_normal = r.render(cam())
    r.set_config(debug_aabbs=True)
    r.render(cam())
    out_dbg = r.render(cam())
    # AABB view covers at least as much as the mesh view (boxes enclose meshes)
    cov_n = (np.asarray(out_normal["vis"].tri_id) != NO_TRIANGLE).sum()
    cov_d = (np.asarray(out_dbg["vis"].tri_id) != NO_TRIANGLE).sum()
    assert cov_d >= cov_n
    # two distinct plans compiled
    assert r.stats["compiles"] == 2
    # debug colors differ from lambert shading
    assert np.abs(np.asarray(out_dbg["image"]) - np.asarray(out_normal["image"])).max() > 0.05


def test_graph_validates_and_dumps():
    from renderer_jax.graph.dot import graph_to_dot, plan_to_dot

    g = build_forward_graph(CFG)
    g.validate()
    plan = g.compile(outputs=["image"], switches={"debug_aabbs": False, "freeze_culling": False})
    names = [p.name for p in plan.passes]
    assert names == ["pose", "prepare", "cull", "raster", "shade", "present"]
    plan_dbg = g.compile(outputs=["image"], switches={"debug_aabbs": True, "freeze_culling": False})
    names_dbg = [p.name for p in plan_dbg.passes]
    assert "aabb_soup" in names_dbg and "cull" not in names_dbg
    dot = graph_to_dot(g)
    assert "aabb_soup" in dot
    assert "cull" in plan_to_dot(plan)


def test_pallas_pbr_matches_xla_pbr_image():
    """End-to-end image equivalence: the Pallas pipeline (fused records +
    shade-side barycentrics, interpret mode) must match the plain-XLA
    pipeline's PBR image. Guards the record/bary plumbing — a record-layout
    bug once produced an all-dark image that no numeric unit test caught."""
    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.models import textured_scene
    from renderer_jax.scene import SceneLimits

    scene = textured_scene(SceneLimits.tiny(), atlas_size=32)
    cam = Camera.create(position=jnp.array([0.0, 1.2, 4.0]), fov_y=0.9, near=0.1, far=60.0)

    def render(use_pallas):
        cfg = PipelineConfig(
            width=128, height=64, tri_capacity=4096,
            use_pallas=use_pallas, shading="pbr",
        )
        r = Renderer(scene, cfg, outputs=("image",))
        return np.asarray(r.render(cam)["image"])

    img_p = render(True)
    img_x = render(False)
    assert img_p.mean() > 0.05, "pallas image is dark — record/bary plumbing broken"
    # the two rasterizers pick different winners on depth-tied edge pixels;
    # interiors must agree tightly and overall brightness must match
    err = np.abs(img_p - img_x)
    assert (err < 0.02).mean() > 0.95, (err.max(), err.mean())
    assert err.mean() < 0.005, err.mean()
    assert abs(img_p.mean() - img_x.mean()) < 0.01


def test_cluster_cull_pipeline_image_parity():
    """cluster_cull=True produces the same image as the default path (the
    cluster stage may only remove triangles the per-triangle cull kills)."""
    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.models import textured_scene
    from renderer_jax.scene import SceneLimits

    scene = textured_scene(SceneLimits.tiny(), atlas_size=16)
    cam = Camera.create(position=jnp.array([0.0, 1.2, 4.0]), fov_y=0.9, near=0.1, far=60.0)

    def render(cluster_cull):
        cfg = PipelineConfig(
            width=128, height=64, tri_capacity=4096,
            use_pallas=True, shading="pbr",
            cluster_cull=cluster_cull,
        )
        r = Renderer(scene, cfg, outputs=("image", "vis"))
        out = r.render(cam)
        return np.asarray(out["image"]), np.asarray(out["vis"].tri_id)

    img_off, id_off = render(False)
    img_on, id_on = render(True)
    np.testing.assert_array_equal(id_off != -1, id_on != -1)
    np.testing.assert_allclose(img_off, img_on, atol=2e-6)


def test_reference_image_switch():
    """The reference_image switch composites a low-res XLA-reference diff
    heatmap (the reference_rt runtime A/B blit, reference_raytracer.rs:34-93).
    With both paths healthy the heatmap stays silent: output == plain frame."""
    cfg = PipelineConfig(width=64, height=64, tri_capacity=256, shading="pbr")
    r = Renderer(small_scene(), cfg)
    plain = np.asarray(r.render(cam())["image"])
    r.set_config(reference_image=True)
    r.apply_config_now()
    ab = np.asarray(r.render(cam())["image"])
    assert np.isfinite(ab).all()
    # healthy paths agree -> almost no pixels tinted
    tinted = (np.abs(ab - plain).max(axis=-1) > 1e-6).mean()
    assert tinted < 0.02, f"{tinted:.3f} of pixels tinted on a healthy frame"
    # a poisoned main image must light the heatmap up (the A/B catches it)
    plan = r.plans.plan(r.config.as_dict())
    names = [p.name for p in plan.passes]
    assert "reference_view" in names
