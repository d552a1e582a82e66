"""SPMD rendering tests on the virtual 8-device CPU mesh.

The multi-chip path compiles THE SAME frame graph under shard_map
(PipelineConfig.spmd_devices + Renderer(spmd_mesh=...)); these tests assert
ulp-level equality with the single-device plan across runtime switches —
shadows, occlusion culling, and SSAA included."""

import numpy as np
import jax
import jax.numpy as jnp

from renderer_jax.mathx.camera import Camera
from renderer_jax.parallel import make_mesh, render_frame_spmd
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.scene import SceneLimits

WIDTH, HEIGHT = 128, 256  # pallas shard rows: height % (8 * TILE_H) == 0


def small_scene():
    from renderer_jax.scene import SceneBuilder, primitives

    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=16.0))
    sph = b.add_mesh(primitives.uv_sphere(rings=8, sectors=12))
    box = b.add_mesh(primitives.box())
    checker = b.add_texture(primitives.checkerboard_texture(16, squares=4))
    floor = b.add_material(roughness=0.6, base_color_tex=checker)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.4)
    b.add_instance(plane, floor, translation=(0, -0.6, 0))
    b.add_instance(sph, red, translation=(-0.9, 0, 0), scale=1.1)
    b.add_instance(box, red, translation=(0.9, 0, 0))
    b.add_light(position=(3.0, 5.0, 4.0), intensity=30.0)
    b.add_light(position=(-0.5, -1.0, -0.3), directional=True, intensity=0.5, shadow_slot=0)
    return b.build()


def camera():
    return Camera.create(
        position=jnp.array([0.0, 1.2, 4.0]), fov_y=0.9, near=0.1, far=60.0
    )


def _render(scene, spmd, mesh, ssaa=1, **switches):
    cfg = PipelineConfig(
        width=WIDTH, height=HEIGHT // ssaa, tri_capacity=8192,
        use_pallas=True, shading="pbr", ssaa=ssaa,
        shadow_slots=2, shadow_size=64,
        spmd_devices=8 if spmd else 1,
    )
    r = Renderer(scene, cfg, outputs=("image", "vis"), spmd_mesh=mesh if spmd else None)
    if switches:
        r.set_config(**switches)
        r.apply_config_now()
    return r.render(camera())


def test_spmd_graph_matches_single_device_across_switches():
    n_dev = len(jax.devices())
    assert n_dev == 8, "conftest should force 8 CPU devices"
    scene = small_scene()
    mesh = make_mesh()

    for sw in ({}, {"shadows": True, "occlusion_culling": True}):
        out1 = _render(scene, False, None, **sw)
        out8 = _render(scene, True, mesh, **sw)
        img1 = np.asarray(out1["image"])
        img8 = np.asarray(out8["image"])
        np.testing.assert_array_equal(
            np.asarray(out1["vis"].tri_id) != -1,
            np.asarray(out8["vis"].tri_id) != -1,
        )
        # same triangles, same math; only shape-dependent FMA contraction
        # in the sharded vs full-height shade kernels differs (~1 ulp)
        np.testing.assert_allclose(img1, img8, atol=2e-6)


def test_spmd_ssaa_resolve():
    """SSAA renders+resolves under SPMD through the same plan."""
    scene = small_scene()
    mesh = make_mesh()
    out1 = _render(scene, False, None, ssaa=2)
    out8 = _render(scene, True, mesh, ssaa=2)
    np.testing.assert_allclose(
        np.asarray(out1["image"]), np.asarray(out8["image"]), atol=2e-6
    )


def test_spmd_state_is_row_sharded():
    """The persistent visibility buffer lives row-sharded across the mesh."""
    scene = small_scene()
    mesh = make_mesh()
    out = _render(scene, True, mesh)
    shard_shapes = {tuple(s.data.shape) for s in out["vis"].depth.addressable_shards}
    assert shard_shapes == {(HEIGHT // 8, WIDTH)}, shard_shapes


def test_render_frame_spmd_driver():
    """The convenience one-shot driver produces a finite, covered frame."""
    scene = small_scene()
    mesh = make_mesh()
    img, depth, tri_id = render_frame_spmd(
        scene, camera(), mesh, WIDTH, HEIGHT, tri_capacity_per_device=1024
    )
    img = np.asarray(img)
    assert img.shape == (HEIGHT, WIDTH, 3)
    assert np.isfinite(img).all()
    assert (np.asarray(tri_id) != -1).any()


def test_spmd_rt_and_hud_switches():
    """rt (grid-accelerated shadows) and hud (overlay) also run under SPMD
    through the same plan, matching single-device."""
    from renderer_jax.ops.overlay import hud_overlay

    scene = small_scene()
    mesh = make_mesh()

    out1 = _render(scene, False, None, **{"rt": True})
    out8 = _render(scene, True, mesh, **{"rt": True})
    np.testing.assert_allclose(
        np.asarray(out1["image"]), np.asarray(out8["image"]), atol=2e-6
    )

    # hud: overlay composites after the row gather; smoke + parity
    ov = hud_overlay("SPMD OK", WIDTH)
    cfg = PipelineConfig(
        width=WIDTH, height=HEIGHT, tri_capacity=8192,
        use_pallas=True, shading="pbr",
        spmd_devices=8,
    )
    r = Renderer(scene, cfg, outputs=("image",), spmd_mesh=mesh)
    r.set_config(hud=True)
    r.apply_config_now()
    img = np.asarray(r.render(camera(), overlay=ov)["image"])
    assert img.shape == (HEIGHT, WIDTH, 3)
    assert np.isfinite(img).all()
    # the panel darkened the top-left corner
    base = _render(scene, True, mesh)
    assert img[6, 6].mean() < np.asarray(base["image"])[6, 6].mean() + 1e-6


def test_spmd_checkerboard_shade_tier():
    """shade_rate="checkerboard" under SPMD: the reconstruction's up/dn
    neighbor rows at shard edges are interior image rows, exchanged with the
    adjacent shards over one ppermute each way (ops/pbr._halo_rows) — the
    row-sharded frame must equal the single-device frame exactly (before the
    fix, the clamped shard edges diverged by up to 8e-3 on boundary rows)."""
    scene = small_scene()
    mesh = make_mesh()

    def render(spmd):
        cfg = PipelineConfig(
            width=WIDTH, height=HEIGHT, tri_capacity=8192,
            use_pallas=True, shading="pbr",
            shade_rate="checkerboard",
            spmd_devices=8 if spmd else 1,
        )
        r = Renderer(
            scene, cfg, outputs=("image",), spmd_mesh=mesh if spmd else None
        )
        return np.asarray(r.render(camera())["image"])

    out1 = render(False)
    out8 = render(True)
    np.testing.assert_allclose(out1, out8, atol=2e-6)


def test_spmd_quarter_shade_tier():
    """shade_rate="quarter" under SPMD: the V/D reconstruction classes read
    lattice row i+1, which crosses the shard edge on each shard's last row
    — exchanged via _halo_rows' below-row ppermute (including the
    column-shifted halo of the diagonal class). Sharded == single-device."""
    scene = small_scene()
    mesh = make_mesh()

    def render(spmd):
        cfg = PipelineConfig(
            width=WIDTH, height=HEIGHT, tri_capacity=8192,
            use_pallas=True, shading="pbr",
            shade_rate="quarter",
            spmd_devices=8 if spmd else 1,
        )
        r = Renderer(
            scene, cfg, outputs=("image",), spmd_mesh=mesh if spmd else None
        )
        return np.asarray(r.render(camera())["image"])

    out1 = render(False)
    out8 = render(True)
    np.testing.assert_allclose(out1, out8, atol=2e-6)
