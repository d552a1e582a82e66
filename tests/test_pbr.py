"""PBR shading tests (analytic checks of the GGX pipeline)."""

import numpy as np
import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives


def flat_plane_scene(
    metallic=0.0, roughness=0.5, tex=None, normal_tex=None,
    light_dir=(0.0, -1.0, 0.0),
):
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    pl = b.add_mesh(primitives.plane(size=10.0))
    kwargs = {}
    if tex is not None:
        kwargs["base_color_tex"] = b.add_texture(tex)
    if normal_tex is not None:
        kwargs["normal_tex"] = b.add_texture(normal_tex)
    m = b.add_material(base_color=(1, 1, 1, 1), metallic=metallic, roughness=roughness, **kwargs)
    b.add_instance(pl, m)
    b.add_light(position=light_dir, directional=True, intensity=3.0)
    return b.build()


def top_down_camera():
    return Camera.create(
        position=jnp.array([0.0, 2.0, 0.0]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        near=0.1,
        far=50.0,
    )


def render(scene, **cfg_kw):
    cfg = PipelineConfig(width=32, height=32, tri_capacity=256, shading="pbr", **cfg_kw)
    r = Renderer(scene, cfg)
    return np.asarray(r.render(top_down_camera())["image"])


def test_lambertian_limit():
    """Rough dielectric lit head-on: color ~ albedo*(1-F)*I/pi + ambient +
    a small specular lobe. Check against the analytic BRDF value."""
    img = render(flat_plane_scene(metallic=0.0, roughness=1.0))
    center = img[16, 16]
    # analytic: n=v=l=+Y => ndl=ndv=ndh=vdh=1
    a = 1.0
    d = 1.0 / np.pi  # a2=1: D = 1/(pi * 1)
    vis = 0.5 / (1.0 + 1.0)
    f = 0.04
    spec = d * vis * f
    diff = (1 - f) / np.pi
    expect = 0.03 + 3.0 * (diff + spec)
    np.testing.assert_allclose(center, [expect] * 3, rtol=0.02)


def test_metal_has_no_diffuse():
    """Pure metal's head-on reflection is dominated by Fresnel = albedo."""
    # side light at 45 deg: the mirror direction misses the top-down camera,
    # so a metal (no diffuse) goes dark while a dielectric keeps its diffuse.
    side = (1.0, -1.0, 0.0)
    img_metal = render(flat_plane_scene(metallic=1.0, roughness=0.3, light_dir=side))
    img_diel = render(flat_plane_scene(metallic=0.0, roughness=0.3, light_dir=side))
    px = img_diel[16, 16]
    assert not np.allclose(px, [0.05, 0.05, 0.08]), "sampled background"
    assert px.min() > 0.06
    assert img_metal[16, 16].max() < px.min()


def test_base_color_texture_applied():
    tex = np.zeros((16, 16, 4), np.uint8)
    tex[:, :8] = [255, 0, 0, 255]
    tex[:, 8:] = [0, 255, 0, 255]
    img = render(flat_plane_scene(roughness=1.0, tex=tex))
    # plane uv spans [0,1]; left half red-ish, right half green-ish
    left = img[16, 4]
    right = img[16, 28]
    assert left[0] > left[1] * 3
    assert right[1] > right[0] * 3


def test_normal_map_tilts_shading():
    """A flat normal map must reproduce the no-map image; a tilted one must
    darken a head-on light."""
    flat_nm = np.full((16, 16, 4), [128, 128, 255, 255], np.uint8)
    img_flat = render(flat_plane_scene(roughness=1.0, normal_tex=flat_nm))
    img_none = render(flat_plane_scene(roughness=1.0))
    np.testing.assert_allclose(img_flat[16, 16], img_none[16, 16], atol=0.02)

    tilted = np.full((16, 16, 4), [255, 128, 128, 255], np.uint8)  # strong +T tilt
    img_tilt = render(flat_plane_scene(roughness=1.0, normal_tex=tilted))
    assert img_tilt[16, 16].mean() < img_flat[16, 16].mean() - 0.05


def test_checkerboard_shade_tier():
    """shade_rate="checkerboard" (PipelineConfig): the shaded half-lattice
    ((x+y) even) must match the full-rate image to float-fusion noise (same
    math at the same pixel coordinates, just packed — XLA fusion shapes
    shift contraction order by ~1 ulp), and the reconstructed complement
    must track it closely (PSNR gate)."""
    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.models import textured_scene
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer
    from renderer_jax.scene import SceneLimits

    scene = textured_scene(SceneLimits.tiny(), atlas_size=32)
    cam = Camera.create(
        position=jnp.array([0.0, 1.2, 4.0]), fov_y=0.9, near=0.1, far=60.0
    )

    def render(rate):
        cfg = PipelineConfig(
            width=128, height=64, tri_capacity=4096,
            use_pallas=True, shading="pbr",
            shade_rate=rate,
        )
        r = Renderer(scene, cfg, outputs=("image",))
        return np.asarray(r.render(cam)["image"])

    full = render("full")
    cb = render("checkerboard")
    assert np.isfinite(cb).all()

    yy, xx = np.mgrid[0:64, 0:128]
    shaded = (xx + yy) % 2 == 0
    np.testing.assert_allclose(cb[shaded], full[shaded], atol=1e-6)

    # 128x64 is edge/texel-dominated (triangles are a few pixels wide), the
    # worst case for neighbor reconstruction — the 1080p bench frame
    # gates at 40 dB (bench.py); _checkerboard_expand is exact for
    # locally-linear fields (interiors) by construction
    mse = np.mean((cb - full) ** 2)
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 28.0, psnr


def test_checkerboard_edge_fix_is_exact():
    """The checkerboard edge fix re-shades suspect reconstructed pixels
    through the SAME shading closure at their true pixel centers — every
    pixel it changes must therefore equal the full-rate frame (same
    expressions, same op order), and the fix must only ever move the frame
    TOWARD the full-rate one."""
    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.models import textured_scene
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer
    from renderer_jax.scene import SceneLimits

    scene = textured_scene(SceneLimits.tiny(), atlas_size=32)
    cam = Camera.create(
        position=jnp.array([0.0, 1.2, 4.0]), fov_y=0.9, near=0.1, far=60.0
    )

    def render(rate, fix):
        cfg = PipelineConfig(
            width=128, height=64, tri_capacity=4096,
            use_pallas=True, shading="pbr",
            shade_rate=rate, shade_fix=fix,
        )
        r = Renderer(scene, cfg, outputs=("image",))
        return np.asarray(r.render(cam)["image"])

    full = render("full", False)
    raw = render("checkerboard", False)
    fixed = render("checkerboard", True)

    # "changed" = materially rewritten by the fix's scatter. The threshold
    # filters ulp-scale drift on UNtouched pixels: the fix=True program is a
    # different XLA compile of the same reconstruction math, and its fusion/
    # FMA-contraction choices can move non-scattered recon values by 1 ulp.
    changed = np.abs(fixed - raw).max(axis=-1) > 1e-5
    assert changed.any(), "the edge fix selected no pixels on an edge-heavy scene"
    # fixed pixels match the full-rate path to cross-shape fusion noise
    # (the (8, K/8) batch compiles with different fusion/FMA-contraction
    # choices than the full grid; same expressions, ulp-scale drift) —
    # far below the reconstruction errors the fix replaces (~0.1)
    np.testing.assert_allclose(fixed[changed], full[changed], atol=1e-4)
    # only complement-lattice ((x+y) odd) pixels may change
    yy, xx = np.mgrid[0:64, 0:128]
    assert not changed[(xx + yy) % 2 == 0].any()
    # net quality must not regress
    def psnr(a, b):
        mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
        return 10 * np.log10(1.0 / max(float(mse), 1e-12))

    assert psnr(fixed, full) >= psnr(raw, full) - 1e-6


def test_quarter_shade_tier():
    """shade_rate="quarter" (the 2x2 VRS analogue): shaded lattice
    (even x, even y) bit-matches the full-rate image; the three
    reconstructed complement classes track it (PSNR floor on an
    edge-heavy worst-case scene)."""
    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.models import textured_scene
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer
    from renderer_jax.scene import SceneLimits

    scene = textured_scene(SceneLimits.tiny(), atlas_size=32)
    cam = Camera.create(
        position=jnp.array([0.0, 1.2, 4.0]), fov_y=0.9, near=0.1, far=60.0
    )

    def render(rate, fix=False):
        cfg = PipelineConfig(
            width=128, height=64, tri_capacity=4096,
            use_pallas=True, shading="pbr",
            shade_rate=rate, shade_fix=fix,
        )
        r = Renderer(scene, cfg, outputs=("image",))
        return np.asarray(r.render(cam)["image"])

    full = render("full")
    q = render("quarter")
    assert np.isfinite(q).all()

    yy, xx = np.mgrid[0:64, 0:128]
    shaded = (xx % 2 == 0) & (yy % 2 == 0)
    np.testing.assert_allclose(q[shaded], full[shaded], atol=1e-6)

    # quarter rate reconstructs 3/4 of an edge-dominated tiny frame: the
    # floor is lower than checkerboard's; this guards against wiring bugs, not quality
    mse = np.mean((q - full) ** 2)
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 24.0, psnr

    # the sparse fix must only move the frame toward full rate, and only
    # on complement pixels
    fixed = render("quarter", True)
    changed = np.abs(fixed - q).max(axis=-1) > 1e-5
    assert changed.any(), "the quarter fix selected no pixels"
    np.testing.assert_allclose(fixed[changed], full[changed], atol=1e-4)
    assert not changed[shaded].any()

    def psnr_of(a, b):
        mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
        return 10 * np.log10(1.0 / max(float(mse), 1e-12))

    assert psnr_of(fixed, full) >= psnr_of(q, full) - 1e-6
