"""Shadow mapping tests: a box on a plane must cast a shadow."""

import numpy as np
import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives


def shadow_scene():
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    floor = b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.8)
    b.add_instance(plane, floor, translation=(0, 0, 0))
    b.add_instance(box, red, translation=(0, 0.8, 0))  # floats above the plane
    # light shining straight down -> shadow directly under the box
    b.add_light(position=(0.0, -1.0, 0.0), directional=True, intensity=3.0, shadow_slot=0)
    return b.build()


def top_down_camera():
    return Camera.create(
        position=jnp.array([0.0, 6.0, 0.01]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        near=0.1,
        far=50.0,
    )


def render(shadows: bool):
    cfg = PipelineConfig(width=64, height=64, tri_capacity=512, shading="pbr")
    r = Renderer(shadow_scene(), cfg)
    r.set_config(shadows=shadows)
    r.apply_config_now()
    return np.asarray(r.render(top_down_camera())["image"])


def test_box_casts_shadow_on_plane():
    lit = render(shadows=False)
    shadowed = render(shadows=True)
    # A point on the plane far from the box: same brightness either way
    corner_l = lit[4, 4].mean()
    corner_s = shadowed[4, 4].mean()
    np.testing.assert_allclose(corner_s, corner_l, atol=0.02)
    # Looking straight down: the box occludes the region under it, but the
    # shadow extends around the box edge? No: straight-down light + straight-
    # down camera means the shadow is exactly hidden by the box. Instead
    # compare a plane point near the box edge with a slightly tilted light.
    assert np.isfinite(shadowed).all()


def test_offset_light_shadow_visible():
    """Tilted light: the shadow lands beside the box and is visible."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    floor = b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.8)
    b.add_instance(plane, floor)
    b.add_instance(box, red, translation=(0, 0.8, 0))
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0, shadow_slot=0)
    scene = b.build()

    cfg = PipelineConfig(width=64, height=64, tri_capacity=512, shading="pbr")

    def run(shadows):
        r = Renderer(scene, cfg)
        r.set_config(shadows=shadows)
        r.apply_config_now()
        return np.asarray(r.render(top_down_camera())["image"])

    lit = run(False)
    shadowed = run(True)
    # light direction (1,-1,0): rays travel toward +X, so the shadow falls on
    # the +X side of the box (image columns ~40-48 with this camera)
    shadow_region = (slice(28, 36), slice(40, 48))
    far_region = (slice(28, 36), slice(4, 16))
    drop = lit[shadow_region].mean() - shadowed[shadow_region].mean()
    far_drop = lit[far_region].mean() - shadowed[far_region].mean()
    assert drop > 0.05, f"expected shadow darkening, got {drop}"
    assert abs(far_drop) < 0.02, f"far region should be unshadowed, {far_drop}"


def test_shadow_atlas_contents():
    """The atlas slot actually contains the casters' depth (per-light path)."""
    from renderer_jax.ops import geometry
    from renderer_jax.ops.shadow import (
        light_matrices_cube,
        render_shadow_atlas_per_light,
    )

    scene = shadow_scene()
    cam = top_down_camera()
    model = geometry.instance_matrices(scene)
    lod = geometry.select_lod(scene, cam, model)
    mats = light_matrices_cube(
        scene.lights, jnp.array([-5.0, -0.5, -5.0]), jnp.array([5.0, 1.3, 5.0])
    )
    atlas = render_shadow_atlas_per_light(
        scene, mats, scene.lights, model, lod, n_slots=2, slot_size=64,
        caster_capacity=512,
    )
    a0 = np.asarray(atlas[0])
    assert (a0 < 1.0).mean() > 0.3, "slot 0 should contain scene depth"
    # slot 1 has no light: empty
    np.testing.assert_array_equal(np.asarray(atlas[1]), 1.0)


def test_point_light_shadow():
    """A point light above a box on a plane: shadow appears under/around it."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    floor = b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.8)
    b.add_instance(plane, floor)
    b.add_instance(box, red, translation=(0.0, 1.0, 0.0), scale=0.6)
    b.add_light(position=(1.5, 4.0, 0.0), intensity=40.0, shadow_slot=0)
    scene = b.build()

    cfg = PipelineConfig(width=64, height=64, tri_capacity=512, shading="pbr")

    def run(shadows):
        r = Renderer(scene, cfg)
        r.set_config(shadows=shadows)
        r.apply_config_now()
        return np.asarray(r.render(top_down_camera())["image"])

    lit = run(False)
    shadowed = run(True)
    diff = (lit - shadowed).mean(axis=-1)
    assert np.isfinite(shadowed).all()
    # shadow falls away from the light (light at +x above -> shadow on -x side)
    assert diff.max() > 0.05, f"expected point-light shadow, max diff {diff.max()}"
    ys, xs = np.where(diff > 0.05)
    assert xs.mean() < 32, "shadow should fall on the -x side"


def test_rt_shadows_match_shadow_maps():
    """The rt switch's ray-traced shadows must agree with the shadow-map
    result on a simple caster (the reference's RT-vs-atlas A/B)."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)), translation=(0, 0.8, 0))
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0, shadow_slot=0)
    scene = b.build()
    cfg = PipelineConfig(width=64, height=64, tri_capacity=512, shading="pbr", rt_scale=1)

    def run(**switches):
        r = Renderer(scene, cfg)
        r.set_config(**switches)
        r.apply_config_now()
        return np.asarray(r.render(top_down_camera())["image"])

    img_sm = run(shadows=True)
    img_rt = run(rt=True)
    img_lit = run()
    # both shadowing modes darken the same region vs the unshadowed image
    drop_sm = (img_lit - img_sm).mean(axis=-1)
    drop_rt = (img_lit - img_rt).mean(axis=-1)
    region = (slice(28, 36), slice(40, 48))
    assert drop_sm[region].mean() > 0.05
    assert drop_rt[region].mean() > 0.05
    # shadow masks agree on most pixels (edge texels may differ)
    agree = ((drop_sm > 0.03) == (drop_rt > 0.03)).mean()
    assert agree > 0.97, f"rt vs shadow-map agreement {agree:.3f}"


def test_off_camera_caster_shadows_visible_floor():
    """A box entirely OUTSIDE the camera frustum must still cast its shadow
    onto the visible floor (per-light caster culling; ref: the reference
    renders each light's slot from its own draw set, shadow_mapping.rs)."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=40.0))
    box = b.add_mesh(primitives.box())
    floor = b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.8)
    b.add_instance(plane, floor)
    # caster way off to the -x side, far outside the narrow camera frustum
    b.add_instance(box, red, translation=(-9.0, 2.0, 0.0), scale=2.0)
    # sun travelling (+x, -y): the off-camera box's shadow lands in view
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0,
                shadow_slot=0)
    scene = b.build()

    cam = Camera.create(
        position=jnp.array([-6.0, 6.0, 0.01]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        fov_y=0.5,  # narrow: the box at x=-10 is far outside
        near=0.1, far=50.0,
    )
    cfg = PipelineConfig(width=64, height=64, tri_capacity=1024, shading="pbr")

    def render(shadows):
        r = Renderer(scene, cfg, outputs=("image", "soup"))
        r.set_config(shadows=shadows)
        r.apply_config_now()
        out = r.render(cam)
        # the caster must not be in the camera-culled draw stream (the plane
        # contributes at most 2 triangles)
        assert int(out["soup"].count) <= 2
        return np.asarray(out["image"])

    lit = render(False)
    shadowed = render(True)
    # the shadow darkens part of the visible floor even though the caster is
    # never in the camera-culled draw stream
    diff = (lit - shadowed).mean(axis=-1)
    assert diff.max() > 0.05, diff.max()
    assert (diff > 0.05).mean() > 0.01


def test_rt_grid_matches_brute_force():
    """The accelerated light-space-grid RT path (Pallas, interpret) must
    agree with the brute-force Moller-Trumbore ray caster — both are exact
    analytic occlusion; only bias conventions differ at contact edges."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)), translation=(0, 0.8, 0))
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0, shadow_slot=0)
    scene = b.build()

    def run(use_pallas):
        cfg = PipelineConfig(
            width=128, height=64, tri_capacity=512, shading="pbr", rt_scale=1,
            use_pallas=use_pallas,
        )
        r = Renderer(scene, cfg)
        r.set_config(rt=True)
        r.apply_config_now()
        return np.asarray(r.render(top_down_camera())["image"])

    img_grid = run(True)
    img_brute = run(False)
    # same shadow: the darkened region agrees on the vast majority of pixels
    # (raster edge ties + bias conventions differ on a thin boundary)
    close = np.abs(img_grid - img_brute).max(-1) < 0.04
    assert close.mean() > 0.97, close.mean()
    # and there IS a shadow in the grid image (not all-lit)
    cfg = PipelineConfig(width=128, height=64, tri_capacity=512, shading="pbr",
                         use_pallas=True)
    r = Renderer(scene, cfg)
    lit = np.asarray(r.render(top_down_camera())["image"])
    assert (lit - img_grid).max() > 0.05


def test_rt_grid_off_camera_caster():
    """Accelerated RT shadows use per-light caster expansion: geometry
    outside the camera frustum still occludes (the brute-force path cannot —
    it rays against the camera-culled stream)."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=40.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)),
                   translation=(-9.0, 2.0, 0.0), scale=2.0)
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0,
                shadow_slot=0)
    scene = b.build()
    cam = Camera.create(
        position=jnp.array([-6.0, 6.0, 0.01]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        fov_y=0.5, near=0.1, far=50.0,
    )
    cfg = PipelineConfig(width=128, height=64, tri_capacity=512, shading="pbr",
                         use_pallas=True)

    def run(rt):
        r = Renderer(scene, cfg)
        r.set_config(rt=rt)
        r.apply_config_now()
        return np.asarray(r.render(cam)["image"])

    lit = run(False)
    shadowed = run(True)
    diff = (lit - shadowed).mean(axis=-1)
    assert diff.max() > 0.05, diff.max()


def test_point_light_cube_shadows_all_directions():
    """A point light surrounded by four boxes must cast four radial shadows
    simultaneously — needs the cube faces (the old single-face camera aimed
    at the scene center could capture only one direction)."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=20.0))
    box = b.add_mesh(primitives.box())
    floor = b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.8)
    b.add_instance(plane, floor)
    for dx, dz in ((2.5, 0), (-2.5, 0), (0, 2.5), (0, -2.5)):
        b.add_instance(box, red, translation=(dx, 1.0, dz), scale=0.7)
    # light low above the floor center: box shadows project radially outward
    b.add_light(position=(0.0, 2.0, 0.0), intensity=60.0, shadow_slot=0)
    scene = b.build()

    cam = Camera.create(
        position=jnp.array([0.0, 12.0, 0.01]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        near=0.1, far=60.0,
    )
    cfg = PipelineConfig(width=96, height=96, tri_capacity=1024, shading="pbr")

    def run(shadows):
        r = Renderer(scene, cfg)
        r.set_config(shadows=shadows)
        r.apply_config_now()
        return np.asarray(r.render(cam)["image"])

    lit = run(False)
    shadowed = run(True)
    diff = (lit - shadowed).mean(axis=-1)
    # the overhead view maps world +x to +col, +z to +row around the center;
    # beyond each box (radially outward) the floor must darken
    cx = cy = 48
    # world->pixel: view half-extent ~= 12*tan(fov/2) ~ 7.3; 3.6m ~ 24 px
    off = 24
    regions = {
        "+x": diff[cy - 4 : cy + 4, cx + off - 6 : cx + off + 6],
        "-x": diff[cy - 4 : cy + 4, cx - off - 6 : cx - off + 6],
        "+z": diff[cy + off - 6 : cy + off + 6, cx - 4 : cx + 4],
        "-z": diff[cy - off - 6 : cy - off + 6, cx - 4 : cx + 4],
    }
    for name, reg in regions.items():
        assert reg.max() > 0.04, f"no shadow beyond the {name} box: {reg.max()}"
    # directly under the light (between the boxes) the floor stays lit
    assert abs(diff[cy - 3 : cy + 3, cx - 3 : cx + 3]).max() < 0.02


def test_shadow_lod_picked_by_light_distance():
    """A caster far from the CAMERA but near a point LIGHT must cast at fine
    LOD (ref shadow_mapping.rs:462 picks caster LOD by light distance)."""
    import jax

    from renderer_jax.ops import geometry
    from renderer_jax.ops.shadow import (
        light_matrices_cube,
        lod_by_distance,
        render_shadow_atlas_per_light,
    )
    from renderer_jax.scene.builder import HostMesh

    box_m = primitives.box()
    # LOD1 = a single triangle of the box: dramatic simplification
    detailed = HostMesh(
        positions=box_m.positions, normals=box_m.normals, uvs=box_m.uvs,
        indices=box_m.indices, lods=[box_m.indices[:1]],
    )
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    mesh = b.add_mesh(detailed)
    mat = b.add_material(base_color=(0.8, 0.2, 0.2, 1))
    b.add_instance(mesh, mat, translation=(0.0, 0.0, -400.0))
    # point light right next to the caster; camera (see below) is 400 away
    b.add_light(position=(2.5, 0.0, -400.0), intensity=40.0, shadow_slot=0)
    scene = b.build()

    cam = Camera.create(position=jnp.array([0.0, 0.0, 1.0]), near=0.1, far=1000.0)
    prepared = jax.jit(geometry.prepare_frame_columns)(scene, cam)
    model, lod_cam = prepared[0], prepared[4]
    smin, smax = prepared[5], prepared[6]

    # the camera pick demotes the far caster; the light pick keeps it fine
    assert int(lod_cam[0]) >= 1  # demoted (clamped to the padded chain)
    lod_light = jax.jit(lod_by_distance)(scene, model, scene.lights.position[0])
    assert int(lod_light[0]) == 0

    mats = light_matrices_cube(scene.lights, smin, smax)
    atlas = jax.jit(
        lambda s, m, mo, lo: render_shadow_atlas_per_light(
            s, m, s.lights, mo, lo, 1, 64, 512
        )
    )(scene, mats, model, lod_cam)
    # the full-detail box writes more covered texels than its 1-tri LOD would
    covered = np.asarray((atlas[0] < 1.0).sum())
    # move the light far away: the light pick goes coarse, coverage drops
    far_lights = scene.lights._replace(
        position=scene.lights.position.at[0].set(jnp.array([2.5, 0.0, 400.0]))
    )
    far_scene = scene._replace(lights=far_lights)
    far_mats = light_matrices_cube(far_scene.lights, smin, smax)
    atlas_far = jax.jit(
        lambda s, m, mo, lo: render_shadow_atlas_per_light(
            s, m, s.lights, mo, lo, 1, 64, 512
        )
    )(far_scene, far_mats, model, lod_cam)
    covered_far = np.asarray((atlas_far[0] < 1.0).sum())
    assert covered > 0
    assert covered_far < covered


def test_rt_grid_point_light():
    """POINT lights trace through the same grid kernel per cube face
    (homogeneous perspective formulation): the rt switch must agree with
    the cube shadow maps on a point-lit scene (ref: ray query handles any
    light from one TLAS, gltf_mesh.frag:136-160)."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)),
                   translation=(0.0, 1.0, 0.0), scale=0.6)
    b.add_light(position=(1.5, 4.0, 0.0), intensity=40.0, shadow_slot=0)
    scene = b.build()
    cfg = PipelineConfig(width=128, height=64, tri_capacity=512, shading="pbr",
                         rt_scale=1, use_pallas=True,
                         shadow_size=256)

    def run(**switches):
        r = Renderer(scene, cfg)
        r.set_config(**switches)
        r.apply_config_now()
        return np.asarray(r.render(top_down_camera())["image"])

    lit = run()
    img_rt = run(rt=True)
    img_sm = run(shadows=True)
    drop_rt = (lit - img_rt).mean(axis=-1)
    drop_sm = (lit - img_sm).mean(axis=-1)
    # a real shadow appears, on the side away from the light (-x)
    assert drop_rt.max() > 0.05, drop_rt.max()
    ys, xs = np.where(drop_rt > 0.05)
    assert xs.mean() < 64
    # rt and cube shadow maps agree on most pixels (rt is exact; the map
    # has finite resolution + bias, so edges differ)
    agree = ((drop_rt > 0.03) == (drop_sm > 0.03)).mean()
    assert agree > 0.94, f"point rt vs cube-map agreement {agree:.3f}"


def test_rt_production_tier_scale():
    """rt_scale>1 (the production rt tier): occlusion traced on a 1/s grid
    + triangle-ID bilateral upsample must closely track the exact full-res
    trace — same shadow, softer edge — and never bleed across surfaces."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=20.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)),
                   translation=(0.0, 1.2, 0.0), scale=1.2)
    b.add_light(position=(0.6, -1.0, 0.2), directional=True, intensity=3.0,
                shadow_slot=0)
    scene = b.build()
    cam = Camera.create(
        position=jnp.array([0.0, 7.0, 0.01]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        fov_y=0.8, near=0.1, far=50.0,
    )

    def run(scale, rt=True):
        cfg = PipelineConfig(
            width=128, height=64, tri_capacity=512, shading="pbr",
            use_pallas=True, rt_scale=scale,
        )
        r = Renderer(scene, cfg, outputs=("image",))
        r.set_config(rt=rt)
        r.apply_config_now()
        return np.asarray(r.render(cam)["image"])

    lit = run(1, rt=False)
    exact = run(1)
    fast = run(2)
    assert np.isfinite(fast).all()
    # both tiers darken some pixels vs the unshadowed frame (a shadow)
    for name, img in (("exact", exact), ("fast", fast)):
        dark = (lit.mean(axis=-1) - img.mean(axis=-1)) > 0.05
        assert dark.sum() > 20, f"{name}: no shadow rendered"
    mse = float(np.mean((np.clip(fast, 0, 1) - np.clip(exact, 0, 1)) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 24.0, psnr
