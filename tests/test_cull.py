"""Compaction + cull-stage tests (the compact_draw_stream analogue)."""

import numpy as np
import jax
import jax.numpy as jnp

from renderer_jax.ops.cull import compact_soup
from renderer_jax.ops.geometry import TriangleSoup
from renderer_jax.passes.pipeline import empty_soup


def make_soup(capacity, valid_mask, rng):
    s = empty_soup(capacity)
    return s._replace(
        clip=jnp.asarray(rng.normal(size=(capacity, 3, 4)), jnp.float32),
        instance=jnp.arange(capacity, dtype=jnp.int32),
        valid=jnp.asarray(valid_mask),
        count=jnp.int32(capacity),
    )


def test_compact_stable_and_tight():
    rng = np.random.default_rng(0)
    cap = 64
    mask = rng.random(cap) < 0.4
    soup = make_soup(cap, mask, rng)
    out = compact_soup(soup)
    n = int(mask.sum())
    assert int(out.count) == n
    # stable: surviving instances keep relative order
    np.testing.assert_array_equal(
        np.asarray(out.instance[:n]), np.where(mask)[0].astype(np.int32)
    )
    # clip data moved with them
    np.testing.assert_array_equal(
        np.asarray(out.clip[:n]), np.asarray(soup.clip)[mask]
    )
    # valid prefix exactly
    np.testing.assert_array_equal(np.asarray(out.valid), np.arange(cap) < n)


def test_compact_all_and_none():
    rng = np.random.default_rng(1)
    soup = make_soup(32, np.ones(32, bool), rng)
    out = compact_soup(soup)
    assert int(out.count) == 32
    np.testing.assert_array_equal(np.asarray(out.clip), np.asarray(soup.clip))

    soup0 = make_soup(32, np.zeros(32, bool), rng)
    out0 = compact_soup(soup0)
    assert int(out0.count) == 0
    assert not np.asarray(out0.valid).any()


def test_compact_under_jit_and_raster_count():
    """Compaction + count-bounded raster give identical images to unbounded."""
    from renderer_jax.ops.raster_jax import rasterize

    rng = np.random.default_rng(2)
    cap = 256
    # a few real triangles among garbage
    clip = np.zeros((cap, 3, 4), np.float32)
    mask = np.zeros(cap, bool)
    for k, x in enumerate(np.linspace(-0.5, 0.5, 5)):
        i = int(rng.integers(0, cap))
        mask[i] = True
        clip[i] = [[-0.3 + x, -0.3, 0.5, 1], [0.3 + x, -0.3, 0.5, 1], [x, 0.4, 0.5, 1]]
    soup = make_soup(cap, mask, rng)._replace(clip=jnp.asarray(clip))
    out = jax.jit(compact_soup)(soup)
    vis_bounded = rasterize(out.clip, out.valid, 64, 64, count=out.count)
    vis_full = rasterize(out.clip, out.valid, 64, 64)
    np.testing.assert_array_equal(np.asarray(vis_bounded.tri_id), np.asarray(vis_full.tri_id))
    np.testing.assert_array_equal(np.asarray(vis_bounded.depth), np.asarray(vis_full.depth))


def test_two_phase_matches_legacy_expansion():
    """Property: the fused two-phase expand/cull/sort selects exactly the
    same (instance, triangle) set as the legacy expand -> cull -> compact
    path, on randomized scenes."""
    import jax
    from renderer_jax.mathx.camera import Camera, camera_matrices
    from renderer_jax.ops import geometry
    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    rng = np.random.default_rng(11)
    for trial in range(3):
        b = SceneBuilder(SceneLimits.tiny())
        meshes = [
            b.add_mesh(primitives.box()),
            b.add_mesh(primitives.uv_sphere(rings=5, sectors=7)),
        ]
        m = b.add_material()
        for i in range(12):
            b.add_instance(
                meshes[i % 2], m,
                translation=tuple(rng.uniform(-6, 6, 3)),
                scale=float(rng.uniform(0.4, 1.5)),
            )
        scene = b.build()
        cam = Camera.create(position=jnp.array([0.0, 1.0, 6.0]), near=0.1, far=40.0)
        model = geometry.instance_matrices(scene)
        vp, clip_mats = geometry.camera_clip_matrices(cam, model)
        visible = geometry.coarse_cull(scene, model, vp)
        lod = geometry.select_lod(scene, cam, model)

        fused = geometry.expand_cull_sort_two_phase(
            scene, visible, lod, clip_mats, model, 2048, 1024, 128, 64
        )
        legacy = compact_soup(
            geometry.cull_triangles(
                geometry.expand_draw_stream(scene, visible, lod, clip_mats, model, 2048)
            )
        )
        assert int(fused.count) == int(legacy.count)
        n = int(fused.count)
        # same (owner, tri) set (order differs: Morton vs stream order)
        set_f = set(zip(np.asarray(fused.instance[:n]).tolist(), np.asarray(fused.tri_idx[:n]).tolist()))
        set_l = set(zip(np.asarray(legacy.instance[:n]).tolist(), np.asarray(legacy.tri_idx[:n]).tolist()))
        assert set_f == set_l
        # clip positions agree for matching (owner, tri) pairs
        key_f = {k: i for i, k in enumerate(zip(np.asarray(fused.instance[:n]).tolist(), np.asarray(fused.tri_idx[:n]).tolist()))}
        cf = np.asarray(fused.clip[:n])
        cl = np.asarray(legacy.clip[:n])
        for i, k in enumerate(zip(np.asarray(legacy.instance[:n]).tolist(), np.asarray(legacy.tri_idx[:n]).tolist())):
            np.testing.assert_allclose(cl[i], cf[key_f[k]], atol=1e-5)


def test_build_draw_stream_matches_legacy():
    """The fused column-math build (wide tri-record gather + fused shade
    records) selects exactly the legacy path's (instance, triangle) set and
    produces matching shade records per pair."""
    from renderer_jax.mathx.camera import Camera
    from renderer_jax.ops import geometry
    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    rng = np.random.default_rng(23)
    b = SceneBuilder(SceneLimits.tiny())
    meshes = [
        b.add_mesh(primitives.box()),
        b.add_mesh(primitives.uv_sphere(rings=5, sectors=7)),
    ]
    m0 = b.add_material(base_color=(0.9, 0.4, 0.2, 1.0), roughness=0.3, metallic=1.0)
    m1 = b.add_material(base_color=(0.2, 0.5, 0.9, 1.0), roughness=0.8)
    for i in range(14):
        b.add_instance(
            meshes[i % 2], m0 if i % 3 else m1,
            translation=tuple(rng.uniform(-6, 6, 3)),
            scale=float(rng.uniform(0.4, 1.5)),
        )
    scene = b.build()
    assert scene.meshes.tri_rec is not None
    cam = Camera.create(position=jnp.array([0.0, 1.0, 6.0]), near=0.1, far=40.0)
    model = geometry.instance_matrices(scene)
    vp, clip_mats = geometry.camera_clip_matrices(cam, model)
    visible = geometry.coarse_cull(scene, model, vp)
    lod = geometry.select_lod(scene, cam, model)

    soup, rec = geometry.build_draw_stream(
        scene, visible, lod, clip_mats, model, 2048, 1024, 128, 64,
        want_soup_attrs=True,
    )
    legacy = compact_soup(
        geometry.cull_triangles(
            geometry.expand_draw_stream(scene, visible, lod, clip_mats, model, 2048)
        )
    )
    legacy = geometry.finalize_tex_lod(legacy, 128, 64, scene.atlas.level_size[0])
    legacy_rec = geometry.build_shade_records(legacy, scene, render_size=(128, 64))

    n = int(soup.count)
    assert n == int(legacy.count) and n > 0
    pairs_f = list(zip(np.asarray(soup.instance[:n]).tolist(), np.asarray(soup.tri_idx[:n]).tolist()))
    pairs_l = list(zip(np.asarray(legacy.instance[:n]).tolist(), np.asarray(legacy.tri_idx[:n]).tolist()))
    assert set(pairs_f) == set(pairs_l)
    where_f = {k: i for i, k in enumerate(pairs_f)}
    rec_f = np.asarray(rec[:n])
    rec_l = np.asarray(legacy_rec[:n])
    clip_f = np.asarray(soup.clip[:n])
    clip_l = np.asarray(legacy.clip[:n])
    for i, k in enumerate(pairs_l):
        j = where_f[k]
        np.testing.assert_allclose(clip_l[i], clip_f[j], atol=1e-5)
        np.testing.assert_allclose(rec_l[i, :40], rec_f[j, :40], rtol=1e-4, atol=1e-4)
        # SR_EDGE cross products cancel exactly for axis-aligned edges; FMA
        # contraction differences leave O(1e-4) residuals where the true
        # value is 0 — compare relative to the row's edge magnitude
        scale = np.abs(rec_l[i, 40:49]).max() + 1e-6
        np.testing.assert_allclose(
            rec_l[i, 40:49] / scale, rec_f[j, 40:49] / scale, atol=1e-3
        )


def test_cluster_cone_culling_is_conservative():
    """Cluster-grain frustum+cone culling (build_draw_stream with camera
    info) must remove ONLY clusters whose every triangle the per-triangle
    cull would kill anyway: the surviving (instance, tri) set equals the
    legacy path's, on randomized rotated scenes and cameras."""
    import jax
    from renderer_jax.mathx.camera import Camera
    from renderer_jax.ops import geometry
    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    rng = np.random.default_rng(42)
    for trial in range(4):
        b = SceneBuilder(SceneLimits.tiny())
        meshes = [
            b.add_mesh(primitives.box()),
            b.add_mesh(primitives.uv_sphere(rings=6, sectors=9)),
            b.add_mesh(primitives.torus(rings=6, sides=5)),
        ]
        m = b.add_material()
        for i in range(10):
            ax = rng.normal(size=3)
            ax /= np.linalg.norm(ax)
            ang = rng.uniform(0, 2 * np.pi)
            q = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * ax])
            b.add_instance(
                meshes[i % 3], m,
                translation=tuple(rng.uniform(-8, 8, 3)),
                rotation=tuple(q),
                scale=float(rng.uniform(0.4, 1.8)),
            )
        scene = b.build()
        assert scene.meshes.cluster_data is not None
        cam = Camera.create(
            position=jnp.asarray(rng.uniform(-4, 4, 3), jnp.float32),
            near=0.1, far=60.0,
        )
        prepared = geometry.prepare_frame_columns(scene, cam)
        model, vp, clip_mats, visible, lod = prepared[:5]

        # under jit: FMA contraction once let degenerate cluster padding
        # pass the det test — the jitted path is the one that must be exact
        soup, _ = jax.jit(
            lambda s, v, l, cm, mo, cp, vpm: geometry.build_draw_stream(
                s, v, l, cm, mo, 4096, 2048, 128, 64, camera_pos=cp, vp=vpm
            )
        )(scene, visible, lod, clip_mats, model, prepared[8], vp)
        legacy = compact_soup(
            geometry.cull_triangles(
                geometry.expand_draw_stream(scene, visible, lod, clip_mats, model, 4096)
            )
        )
        n_f, n_l = int(soup.count), int(legacy.count)
        set_f = set(zip(np.asarray(soup.instance[:n_f]).tolist(),
                        np.asarray(soup.tri_idx[:n_f]).tolist()))
        set_l = set(zip(np.asarray(legacy.instance[:n_l]).tolist(),
                        np.asarray(legacy.tri_idx[:n_l]).tolist()))
        assert set_f == set_l, (
            f"trial {trial}: cluster culling dropped "
            f"{sorted(set_l - set_f)[:5]} / added {sorted(set_f - set_l)[:5]}"
        )
