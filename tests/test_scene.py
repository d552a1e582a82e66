"""Scene substrate tests: builder consolidation, primitives sanity."""

import numpy as np

from renderer_jax.scene import SceneBuilder, SceneLimits
from renderer_jax.scene import primitives


def test_primitives_shapes():
    for mesh in [primitives.box(), primitives.plane(segments=4), primitives.uv_sphere(), primitives.torus()]:
        v = len(mesh.positions)
        assert mesh.normals.shape == (v, 3)
        assert mesh.uvs.shape == (v, 2)
        assert mesh.indices.ndim == 2 and mesh.indices.shape[1] == 3
        assert mesh.indices.min() >= 0 and mesh.indices.max() < v
        lens = np.linalg.norm(mesh.normals, axis=-1)
        np.testing.assert_allclose(lens, 1.0, atol=1e-4)


def test_winding_matches_normals():
    """Every primitive triangle's cross-product normal must agree with its
    vertex normals (catches inverted winding, which backface culling would
    silently hide)."""
    for name, mesh in [
        ("box", primitives.box()),
        ("plane", primitives.plane(segments=3)),
        ("sphere", primitives.uv_sphere()),
        ("torus", primitives.torus()),
    ]:
        p = mesh.positions
        idx = mesh.indices
        fn = np.cross(p[idx[:, 1]] - p[idx[:, 0]], p[idx[:, 2]] - p[idx[:, 0]])
        lens = np.linalg.norm(fn, axis=-1)
        ok = lens > 1e-12
        fn = fn[ok] / lens[ok, None]
        vn = mesh.normals[idx[ok]].mean(axis=1)
        vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-9)
        dots = np.sum(fn * vn, axis=-1)
        assert np.all(dots > 0), f"{name}: {np.mean(dots < 0):.2%} triangles inverted"


def test_sphere_normals_point_outward():
    m = primitives.uv_sphere(radius=2.0)
    # for a sphere centered at origin, normal == normalize(position)
    expect = m.positions / np.linalg.norm(m.positions, axis=-1, keepdims=True)
    np.testing.assert_allclose(m.normals, expect, atol=1e-5)


def test_builder_consolidation():
    b = SceneBuilder(SceneLimits.tiny())
    box_id = b.add_mesh(primitives.box())
    sph_id = b.add_mesh(primitives.uv_sphere(rings=4, sectors=6))
    mat = b.add_material(base_color=(1, 0, 0, 1))
    b.add_instance(box_id, mat, translation=(1, 0, 0))
    b.add_instance(sph_id, mat, translation=(-1, 0, 0), scale=2.0)
    scene = b.build()

    lib = scene.meshes
    assert int(lib.mesh_count) == 2
    assert int(scene.instances.count) == 2
    # consolidated offsets: sphere comes after box
    assert int(lib.mesh_vertex_offset[1]) == 24
    # indices are library-global: mesh 1's indices land inside its vertex range
    t_off = int(lib.lod_index_offset[1, 0])
    t_cnt = int(lib.lod_tri_count[1, 0])
    tri = np.asarray(lib.indices[t_off : t_off + t_cnt])
    assert tri.min() >= 24
    assert tri.max() < int(lib.vertex_count)
    # AABBs
    np.testing.assert_allclose(np.asarray(lib.mesh_aabb_min[0]), [-0.5] * 3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(lib.mesh_aabb_max[0]), [0.5] * 3, atol=1e-6)
    # instance columns
    assert bool(scene.instances.alive[0]) and bool(scene.instances.alive[1])
    assert not bool(scene.instances.alive[2])
    np.testing.assert_allclose(np.asarray(scene.instances.scale[1]), 2.0)


def test_builder_lods():
    b = SceneBuilder(SceneLimits.tiny())
    mesh = primitives.uv_sphere(rings=6, sectors=8)
    # fake LOD1: first half of the triangles
    half = mesh.indices[: len(mesh.indices) // 2]
    mesh.lods = [half]
    mid = b.add_mesh(mesh)
    scene = b.build()
    lib = scene.meshes
    assert int(lib.lod_tri_count[mid, 0]) == len(mesh.indices)
    assert int(lib.lod_tri_count[mid, 1]) == len(half)
    # missing LODs fall back to last real one
    assert int(lib.lod_tri_count[mid, 5]) == len(half)
    assert int(lib.lod_index_offset[mid, 5]) == int(lib.lod_index_offset[mid, 1])


def test_native_lod_simplifier():
    """Grid-clustering LODs: valid indices into the original pool, strictly
    decreasing triangle counts, non-degenerate, and they render."""
    from renderer_jax.scene.simplify import build_lod_chain, simplify

    m = primitives.uv_sphere(rings=20, sectors=32)
    chain = build_lod_chain(m.positions, m.indices)
    assert len(chain) >= 2
    prev = len(m.indices)
    for idx in chain:
        assert 0 < len(idx) < prev
        assert idx.min() >= 0 and idx.max() < len(m.positions)
        assert not np.any(
            (idx[:, 0] == idx[:, 1]) | (idx[:, 1] == idx[:, 2]) | (idx[:, 0] == idx[:, 2])
        )
        prev = len(idx)
    # coarse LOD keeps the rough shape: surface area within 40% of original
    def area(indices):
        p = m.positions
        e1 = p[indices[:, 1]] - p[indices[:, 0]]
        e2 = p[indices[:, 2]] - p[indices[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()

    a0, a2 = area(m.indices), area(chain[-1])
    assert abs(a2 - a0) / a0 < 0.4, (a0, a2)


def test_builder_auto_lods_render():
    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer

    b = SceneBuilder(SceneLimits.tiny())
    sph = b.add_mesh(primitives.uv_sphere(rings=12, sectors=16), auto_lods=True)
    m = b.add_material()
    # distant instance -> non-zero LOD picked by select_lod (far enough to
    # downshift, near enough that the mesh still covers pixels)
    b.add_instance(sph, m, translation=(0, 0, -12.0), scale=1.5)
    b.add_light(position=(2, 3, 4), intensity=20.0)
    scene = b.build()
    assert int(scene.meshes.lod_tri_count[sph, 2]) < int(scene.meshes.lod_tri_count[sph, 0])
    r = Renderer(scene, PipelineConfig(width=64, height=64, tri_capacity=1024))
    out = r.render(Camera.create(position=jnp.array([0.0, 0.0, 3.0]), far=100.0))
    assert (np.asarray(out["vis"].tri_id) != -1).sum() > 0
