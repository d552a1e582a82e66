"""End-to-end slice: scene -> render_forward -> image, golden vs numpy.

This is the BASELINE.md config-1 milestone (glTF-Box-class scene, flat/lambert
shaded, 256x256) with a PSNR gate.
"""

import numpy as np
import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera, camera_matrices
from renderer_jax.ops.raster_ref import rasterize_ref
from renderer_jax.ops.raster_spec import NO_TRIANGLE
from renderer_jax.passes.forward import render_forward
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives
from renderer_jax.utils.image import psnr


def build_test_scene():
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    sph = b.add_mesh(primitives.uv_sphere(rings=10, sectors=14))
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1.0))
    blue = b.add_material(base_color=(0.2, 0.3, 0.9, 1.0))
    b.add_instance(box, red, translation=(-0.7, 0.0, 0.0))
    b.add_instance(
        sph, blue, translation=(0.7, 0.0, 0.0), scale=1.2,
        rotation=np.asarray(
            mathx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.8)
        ),
    )
    b.add_light(position=(2.0, 3.0, 4.0), intensity=20.0)
    b.add_light(position=(-1.0, -1.0, -0.5), directional=True, intensity=0.4)
    return b.build()


def camera():
    return Camera.create(position=jnp.array([0.0, 0.6, 3.0]), near=0.1, far=50.0)


def reference_image(scene, cam, size, ambient=0.15, background=(0.05, 0.05, 0.08)):
    """Fully-numpy forward pipeline (independent of the jax ops)."""
    s = scene
    n_inst = int(s.instances.count)
    # build the triangle soup in numpy
    clips, worlds, normals, insts = [], [], [], []
    _, _, vp = camera_matrices(cam)
    vp = np.asarray(vp, np.float64)
    for i in range(n_inst):
        q = np.asarray(s.instances.rotation[i], np.float64)
        w, x, y, z = q
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        sc = float(s.instances.scale[i])
        t = np.asarray(s.instances.translation[i], np.float64)
        m = np.eye(4)
        m[:3, :3] = r * sc
        m[:3, 3] = t
        mid = int(s.instances.mesh_id[i])
        t0 = int(s.meshes.lod_index_offset[mid, 0])
        tc = int(s.meshes.lod_tri_count[mid, 0])
        tri = np.asarray(s.meshes.indices[t0 : t0 + tc])
        pos = np.asarray(s.meshes.positions)[tri]  # (T, 3, 3)
        nrm = np.asarray(s.meshes.normals)[tri]
        hpos = np.concatenate([pos, np.ones(pos.shape[:2] + (1,))], axis=-1)
        world = hpos @ m.T
        clip = world @ vp.T
        clips.append(clip)
        worlds.append(world[..., :3])
        normals.append(nrm @ (r * sc).T)
        insts.append(np.full(tc, i))
    clip = np.concatenate(clips)
    world = np.concatenate(worlds)
    normal = np.concatenate(normals)
    inst = np.concatenate(insts)

    flat_clip = clip.reshape(-1, 4)
    tris = np.arange(len(flat_clip)).reshape(-1, 3)
    out = rasterize_ref(flat_clip, tris, size, size)

    covered = out.tri_id != NO_TRIANGLE
    safe = np.maximum(out.tri_id, 0)
    b = out.bary.astype(np.float64)
    pw = np.einsum("hwk,hwkc->hwc", b, world[safe])
    pn = np.einsum("hwk,hwkc->hwc", b, normal[safe])
    pn /= np.maximum(np.linalg.norm(pn, axis=-1, keepdims=True), 1e-8)
    mat = np.asarray(s.instances.material_id)[inst[safe]]
    albedo = np.asarray(s.materials.base_color_factor)[mat][..., :3]

    radiance = np.full_like(albedo, ambient)
    for li in range(int(s.lights.count)):
        if s.lights.directional[li]:
            tl = -np.asarray(s.lights.position[li]) * np.ones_like(pw)
        else:
            tl = np.asarray(s.lights.position[li]) - pw
        d2 = np.sum(tl * tl, axis=-1, keepdims=True)
        l = tl / np.sqrt(np.maximum(d2, 1e-12))
        ndotl = np.maximum(np.sum(pn * l, axis=-1, keepdims=True), 0.0)
        atten = 1.0 if s.lights.directional[li] else 1.0 / np.maximum(d2, 1e-4)
        radiance += ndotl * atten * float(s.lights.intensity[li]) * np.asarray(s.lights.color[li])
    img = albedo * radiance
    img = np.where(covered[..., None], img, np.asarray(background))
    return img.astype(np.float32)


def test_render_forward_box_psnr():
    scene = build_test_scene()
    cam = camera()
    img, vis = render_forward(scene, cam, width=256, height=256, tri_capacity=1024)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    ref = reference_image(scene, cam, 256)
    p = psnr(np.clip(img, 0, 1), np.clip(ref, 0, 1))
    assert p >= 40.0, f"PSNR {p:.1f} dB < 40"
    # something was actually drawn
    assert (np.asarray(vis.tri_id) != NO_TRIANGLE).mean() > 0.1


def test_empty_scene_renders_background():
    scene = SceneBuilder(SceneLimits.tiny()).build()
    img, vis = render_forward(scene, camera(), width=64, height=64, tri_capacity=128)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert np.all(np.asarray(vis.tri_id) == NO_TRIANGLE)
    np.testing.assert_allclose(img, np.broadcast_to([0.05, 0.05, 0.08], img.shape), atol=1e-6)


def test_analytic_directional_shading():
    """Plane facing +Y, directional light straight down: color = albedo*(ambient+I)."""
    b = SceneBuilder(SceneLimits.tiny())
    pl = b.add_mesh(primitives.plane(size=10.0))
    m = b.add_material(base_color=(0.5, 0.6, 0.7, 1.0))
    b.add_instance(pl, m)
    b.add_light(position=(0.0, -1.0, 0.0), directional=True, intensity=0.5)
    scene = b.build()
    cam = Camera.create(
        position=jnp.array([0.0, 2.0, 0.0]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        near=0.1,
        far=50.0,
    )
    img, vis = render_forward(scene, cam, width=32, height=32, tri_capacity=128)
    center = np.asarray(img)[16, 16]
    expect = np.array([0.5, 0.6, 0.7]) * (0.15 + 0.5)
    np.testing.assert_allclose(center, expect, atol=1e-4)


def test_instance_culling_reduces_work():
    """Instances behind the camera are coarse-culled (their soup slots freed)."""
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material()
    b.add_instance(box, m, translation=(0.0, 0.0, 0.0))
    b.add_instance(box, m, translation=(0.0, 0.0, 100.0))  # behind camera
    scene = b.build()
    from renderer_jax.ops import geometry

    model = geometry.instance_matrices(scene)
    vp, clip_mats = geometry.camera_clip_matrices(camera(), model)
    visible = geometry.coarse_cull(scene, model, vp)
    assert bool(visible[0]) and not bool(visible[1])
    lod = geometry.select_lod(scene, camera(), model)
    soup = geometry.expand_draw_stream(scene, visible, lod, clip_mats, model, 128)
    assert int(soup.count) == 12  # only one box's triangles expanded
