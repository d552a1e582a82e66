"""Checks of the GPU-compiled kernels against their plain references.

Shared by the GPU-marked tests (tests/test_gpu.py) and the chip smoke run
(chip_smoke.py, phase 4), so both run the same assertions. Every check
runs on the default device.

Tolerances and their reasons:
- spec cases, ids vs the XLA rasterizer on the same device: exact, as on
  the CPU (tests/test_raster_pallas.py).
- ids vs the float64 numpy reference, and vs the XLA rasterizer on the
  bench's 1080p soup: agreement >= ID_AGREEMENT. A pixel centre lying
  within f32 rounding of an edge shared by two triangles can go to either:
  float64 rounds differently from float32, and on a soup of 100k
  triangles the kernel's FMA-contracted edge functions (Triton) and XLA's
  separately rounded products disagree on a few such pixels.
- depth where the ids agree: <= DEPTH_ATOL (a few f32 ulps of z in
  [0, 1]; the kernel divides once per pixel, the references per triangle).
"""

from __future__ import annotations

import numpy as np

ID_AGREEMENT = 0.999
DEPTH_ATOL = 1e-5


def _pad_soup(clip, valid, quantum=256):
    t = len(clip)
    pad = (-t) % quantum
    clip = np.concatenate([clip, np.zeros((pad, 3, 4), np.float32)])
    valid = np.concatenate([valid, np.zeros(pad, bool)])
    return clip.astype(np.float32), valid


def _mesh_soup(meshes, vp):
    clips = []
    for mesh in meshes:
        h = np.concatenate([mesh.positions, np.ones((len(mesh.positions), 1))], axis=1)
        clips.append((h @ np.asarray(vp, np.float64).T)[mesh.indices])
    clip = np.concatenate(clips).astype(np.float32)
    return _pad_soup(clip, np.ones(len(clip), bool))


def raster_cases():
    """The spec cases of tests/test_raster_pallas.py:
    (name, clip (T,3,4) f32, valid (T,), width, height, cull_backface)."""
    import jax.numpy as jnp

    from renderer_jax import mathx
    from renderer_jax.mathx.camera import Camera, camera_matrices
    from renderer_jax.scene import primitives

    def vp(cam):
        return np.asarray(camera_matrices(cam)[2])

    cases = []
    cam = Camera.create(position=jnp.array([1.2, 1.0, 2.5]), near=0.1, far=20.0, aspect=2.0)
    cases.append(("box", *_mesh_soup([primitives.box()], vp(cam)), 128, 64, True))
    cam = Camera.create(position=jnp.array([0.0, 0.4, 2.4]), near=0.1, far=20.0, aspect=2.0)
    cases.append(("sphere_torus", *_mesh_soup(
        [primitives.uv_sphere(rings=10, sectors=14), primitives.torus()], vp(cam)
    ), 128, 64, True))
    cam = Camera.create(position=jnp.array([0.0, 1.2, 2.0]), near=0.1, far=20.0, aspect=2.0)
    cam = cam._replace(rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -0.5))
    cases.append(("two_sided", *_mesh_soup([primitives.torus()], vp(cam)), 128, 64, False))
    cam = Camera.create(position=jnp.array([0.05, 0.0, 0.1]), near=0.05, far=50.0, aspect=2.0)
    cases.append(("near_crossing", *_mesh_soup([primitives.box(size=4.0)], vp(cam)),
                  128, 64, False))

    rng = np.random.default_rng(7)
    n = 700
    c = rng.uniform(-0.9, 0.9, size=(n, 2))
    z = rng.uniform(0.1, 0.9, size=n)
    tris = np.zeros((n, 3, 4))
    tris[:, :, 3] = 1.0
    tris[:, :, 2] = z[:, None]
    for k, (dx, dy) in enumerate(((-0.05, -0.05), (0.05, -0.05), (0.0, 0.05))):
        tris[:, k, 0] = c[:, 0] + dx
        tris[:, k, 1] = c[:, 1] + dy
    cases.append(("multi_block", *_pad_soup(tris, np.ones(n, bool)), 128, 64, True))

    w, h = 256, 64  # triangles with vertices and edges on tile seams
    px_tris = [
        [(100.0, 10.0), (128.0, 10.0), (114.0, 30.0)],
        [(128.0, 40.0), (156.0, 40.0), (142.0, 60.0)],
        [(40.0, 12.0), (70.0, 12.0), (55.0, 32.0)],
        [(128.0, 32.0), (150.0, 50.0), (120.0, 55.0)],
        [(120.0, 28.0), (140.0, 28.0), (130.0, 44.0)],
    ]
    seam = np.asarray(
        [[[x / w * 2 - 1, 1 - y / h * 2, 0.5, 1.0] for x, y in t] for t in px_tris]
    )
    cases.append(("tile_seams", *_pad_soup(seam, np.ones(len(seam), bool)), w, h, False))

    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        n = 1024
        center = rng.uniform(-1.2, 1.2, size=(n, 2))
        size = rng.uniform(0.01, 0.5, size=(n, 1))
        z = rng.uniform(0.05, 0.95, size=(n, 1))
        offs = rng.uniform(-1.0, 1.0, size=(n, 3, 2))
        tris = np.zeros((n, 3, 4), np.float32)
        tris[:, :, :2] = center[:, None, :] + size[:, None, :] * offs
        tris[:, :, 2] = z
        tris[:, :, 3] = 1.0
        pw = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
        tris[:, :, 3] *= pw[:, None]
        tris[:, :, :3] *= pw[:, None, None]
        cross = rng.random(n) < 0.02
        tris[cross, 0, 3] = -0.1
        valid = rng.random(n) < 0.9
        for cull in (True, False):
            cases.append((f"random{seed}_cull{int(cull)}", tris, valid, 256, 64, cull))
    return cases


def compare_vis(got_id, got_depth, want_id, want_depth) -> dict:
    """Id agreement and the worst depth error where the ids agree."""
    got_id, want_id = np.asarray(got_id), np.asarray(want_id)
    same = got_id == want_id
    err = np.abs(np.asarray(got_depth) - np.asarray(want_depth))[same]
    return {
        "id_agreement": float(same.mean()),
        "depth_max_err": float(err.max()) if err.size else 0.0,
        "covered": float((want_id != -1).mean()),
    }


def check_raster_spec() -> dict:
    """The tile kernel on every spec case against the XLA rasterizer (same
    device) and the float64 numpy reference. Returns per-case stats."""
    import jax.numpy as jnp

    from renderer_jax.ops.raster_jax import rasterize
    from renderer_jax.ops.raster_pallas import rasterize_pallas
    from renderer_jax.ops.raster_ref import rasterize_ref

    stats = {}
    for name, clip, valid, w, h, cull in raster_cases():
        c, v = jnp.asarray(clip), jnp.asarray(valid)
        got = rasterize_pallas(c, v, w, h, cull_backface=cull)
        xla = rasterize(c, v, w, h, cull_backface=cull)
        ref = rasterize_ref(
            clip.reshape(-1, 4), np.arange(3 * len(clip)).reshape(-1, 3), w, h,
            cull_backface=cull, tri_valid=valid,
        )
        s_x = compare_vis(got.tri_id, got.depth, xla.tri_id, xla.depth)
        s_r = compare_vis(got.tri_id, got.depth, ref.tri_id, ref.depth)
        stats[name] = {"vs_xla": s_x, "vs_f64": s_r}
        assert s_x["id_agreement"] == 1.0, (name, stats[name])
        assert s_r["id_agreement"] >= ID_AGREEMENT, (name, stats[name])
        for s in (s_x, s_r):
            assert s["depth_max_err"] <= DEPTH_ATOL, (name, stats[name])
    return stats


def check_pallas_frame_matches_xla_frame() -> dict:
    """A whole PBR frame through the tile kernel vs the plain-XLA pipeline
    (tests/test_pipeline.py's tolerances: depth-tied edge pixels differ)."""
    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.models import textured_scene
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer
    from renderer_jax.scene import SceneLimits

    scene = textured_scene(SceneLimits.tiny(), atlas_size=32)
    cam = Camera.create(position=jnp.array([0.0, 1.2, 4.0]), fov_y=0.9, near=0.1, far=60.0)

    def render(use_pallas):
        cfg = PipelineConfig(width=128, height=64, tri_capacity=4096,
                             use_pallas=use_pallas, shading="pbr")
        return np.asarray(Renderer(scene, cfg, outputs=("image",)).render(cam)["image"])

    img_p, img_x = render(True), render(False)
    err = np.abs(img_p - img_x)
    out = {"mean": float(img_p.mean()), "err_mean": float(err.mean()),
           "frac_close": float((err < 0.02).mean())}
    assert img_p.mean() > 0.05, out
    assert out["frac_close"] > 0.95, out
    assert out["err_mean"] < 0.005, out
    assert abs(img_p.mean() - img_x.mean()) < 0.01, out
    return out


def check_rt_grid_matches_brute_force() -> dict:
    """The light-space grid kernel (rt switch, use_pallas) against the
    brute-force ray caster (ops/rt.py) on an all-on-camera scene
    (tests/test_shadow.py's tolerance: bias conventions differ on a thin
    boundary)."""
    import jax.numpy as jnp

    from renderer_jax import mathx
    from renderer_jax.mathx.camera import Camera
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer
    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)), translation=(0, 0.8, 0))
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0, shadow_slot=0)
    scene = b.build()
    cam = Camera.create(
        position=jnp.array([0.0, 6.0, 0.01]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        near=0.1, far=50.0, aspect=2.0,
    )

    def run(use_pallas, rt=True):
        cfg = PipelineConfig(width=128, height=64, tri_capacity=512, shading="pbr",
                             rt_scale=1, use_pallas=use_pallas)
        r = Renderer(scene, cfg)
        r.set_config(rt=rt)
        r.apply_config_now()
        return np.asarray(r.render(cam)["image"])

    img_grid, img_brute, lit = run(True), run(False), run(True, rt=False)
    close = float((np.abs(img_grid - img_brute).max(-1) < 0.04).mean())
    out = {"frac_close": close, "shadow_depth": float((lit - img_grid).max())}
    assert close > 0.97, out
    assert out["shadow_depth"] > 0.05, out
    return out


def occlusion_case(seed=0, n=1000, h=48, w=96):
    """Random light-space casters over a random receiver grid:
    (clip, valid, lx, ly, ld) for occlusion_grid / occlusion_dense."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, size=(n, 1, 2))
    tris = np.zeros((n, 3, 4), np.float32)
    tris[:, :, :2] = c + rng.uniform(-0.15, 0.15, size=(n, 3, 2))
    tris[:, :, 2] = rng.uniform(0.1, 0.9, size=(n, 1))
    tris[:, :, 3] = 1.0
    clip, valid = _pad_soup(tris, rng.random(n) < 0.9)
    lx = rng.uniform(-1.1, 1.1, size=(h, w)).astype(np.float32)
    ly = rng.uniform(-1.1, 1.1, size=(h, w)).astype(np.float32)
    ld = rng.uniform(0.0, 1.0, size=(h, w)).astype(np.float32)
    ld[rng.random((h, w)) < 0.1] = np.inf  # background receivers
    return clip, valid, lx, ly, ld


def check_occlusion_matches_dense() -> dict:
    """The occlusion kernel against its plain-XLA reference on random
    casters; only receivers within rounding of a caster edge may differ."""
    import jax.numpy as jnp

    from renderer_jax.ops.rt_grid import occlusion_dense, occlusion_grid

    args = [jnp.asarray(a) for a in occlusion_case()]
    got = np.asarray(occlusion_grid(*args))
    want = np.asarray(occlusion_dense(*args))
    out = {"agreement": float((got == want).mean()),
           "shadowed": float((want == 0).mean())}
    assert out["agreement"] >= ID_AGREEMENT, out
    assert 0.05 < out["shadowed"] < 0.95, out
    return out


GPU_CHECKS = (
    check_raster_spec,
    check_pallas_frame_matches_xla_frame,
    check_rt_grid_matches_brute_force,
    check_occlusion_matches_dense,
)
