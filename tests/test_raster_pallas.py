"""Pallas tile rasterizer goldens vs the plain-JAX rasterizer (which is
itself golden-tested against the numpy reference). On the CPU the kernel
runs in the Pallas interpreter; tests/test_gpu.py runs it compiled."""

import numpy as np
import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera, camera_matrices
from renderer_jax.ops.raster_jax import rasterize
from renderer_jax.ops.raster_pallas import rasterize_pallas
from renderer_jax.ops.raster_spec import NO_TRIANGLE
from renderer_jax.scene import primitives


def soup_from_meshes(meshes_and_mats, pad_to=256):
    clips = []
    for mesh, model in meshes_and_mats:
        h = np.concatenate([mesh.positions, np.ones((len(mesh.positions), 1))], axis=1)
        clips.append((h @ np.asarray(model).T)[mesh.indices])
    clip = np.concatenate(clips).astype(np.float32)
    t = len(clip)
    pad = (-t) % pad_to
    clip = np.concatenate([clip, np.zeros((pad, 3, 4), np.float32)])
    valid = np.concatenate([np.ones(t, bool), np.zeros(pad, bool)])
    return jnp.asarray(clip), jnp.asarray(valid)


def compare(mesh_list, cam, width=128, height=64, cull=True):
    _, _, vp = camera_matrices(cam)
    clip, valid = soup_from_meshes([(m, vp) for m in mesh_list])
    got = rasterize_pallas(clip, valid, width, height, cull_backface=cull)
    want = rasterize(clip, valid, width, height, cull_backface=cull)
    id_mismatch = (np.asarray(got.tri_id) != np.asarray(want.tri_id)).mean()
    assert id_mismatch == 0.0, f"tri_id mismatch {id_mismatch:.4%}"
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(want.depth), atol=1e-5)
    # bary diverges most on sliver edges (different FMA association); <2e-3
    np.testing.assert_allclose(np.asarray(got.bary), np.asarray(want.bary), atol=2e-3)
    return got


def test_box_exact_match():
    cam = Camera.create(position=jnp.array([1.2, 1.0, 2.5]), near=0.1, far=20.0, aspect=2.0)
    out = compare([primitives.box()], cam)
    assert (np.asarray(out.tri_id) != NO_TRIANGLE).sum() > 100


def test_sphere_and_torus():
    cam = Camera.create(position=jnp.array([0.0, 0.4, 2.4]), near=0.1, far=20.0, aspect=2.0)
    out = compare(
        [primitives.uv_sphere(rings=10, sectors=14), primitives.torus()], cam
    )
    assert (np.asarray(out.tri_id) != NO_TRIANGLE).sum() > 300


def test_two_sided():
    cam = Camera.create(position=jnp.array([0.0, 1.2, 2.0]), near=0.1, far=20.0, aspect=2.0)
    cam = cam._replace(rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -0.5))
    compare([primitives.torus()], cam, cull=False)


def test_near_crossing():
    cam = Camera.create(position=jnp.array([0.05, 0.0, 0.1]), near=0.05, far=50.0, aspect=2.0)
    compare([primitives.box(size=4.0)], cam, cull=False)


def test_empty():
    clip = jnp.zeros((256, 3, 4), jnp.float32)
    valid = jnp.zeros((256,), bool)
    out = rasterize_pallas(clip, valid, 128, 32)
    assert np.all(np.asarray(out.tri_id) == NO_TRIANGLE)
    assert np.all(np.asarray(out.depth) == 1.0)


def test_multi_block_many_triangles():
    """>BLOCK triangles exercising multiple DMA blocks and binning."""
    rng = np.random.default_rng(7)
    n = 700  # spans 3 blocks after padding to 768
    centers = rng.uniform(-0.9, 0.9, size=(n, 2))
    z = rng.uniform(0.1, 0.9, size=n)
    tris = []
    for k in range(n):
        cx, cy = centers[k]
        r = 0.05
        tris.append(
            [
                [cx - r, cy - r, z[k], 1],
                [cx + r, cy - r, z[k], 1],
                [cx, cy + r, z[k], 1],
            ]
        )
    clip = np.asarray(tris, np.float32)
    pad = (-n) % 256
    clip = np.concatenate([clip, np.zeros((pad, 3, 4), np.float32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    got = rasterize_pallas(jnp.asarray(clip), jnp.asarray(valid), 128, 64)
    want = rasterize(jnp.asarray(clip), jnp.asarray(valid), 128, 64)
    assert (np.asarray(got.tri_id) == np.asarray(want.tri_id)).all()
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(want.depth), atol=1e-6)


def test_y0_sharded_rendering():
    """Rendering row shards with y0 offsets reproduces the full image (the
    multi-chip split-frame contract)."""
    import numpy as np

    cam = Camera.create(position=jnp.array([0.0, 0.3, 2.2]), near=0.1, far=20.0, aspect=2.0)
    _, _, vp = camera_matrices(cam)
    clip, valid = soup_from_meshes([(primitives.uv_sphere(rings=10, sectors=14), vp)])
    full = rasterize_pallas(clip, valid, 128, 64)
    top = rasterize_pallas(clip, valid, 128, 32, y0=0, full_height=64)
    bot = rasterize_pallas(clip, valid, 128, 32, y0=32, full_height=64)
    np.testing.assert_array_equal(
        np.asarray(full.tri_id),
        np.concatenate([np.asarray(top.tri_id), np.asarray(bot.tri_id)]),
    )
    np.testing.assert_allclose(
        np.asarray(full.depth),
        np.concatenate([np.asarray(top.depth), np.asarray(bot.depth)]),
        atol=1e-7,
    )


def test_tile_boundary_aligned_triangles():
    """Bin-bitmask semantics at exact tile boundaries: triangles whose NDC
    bboxes land exactly on TILE_W/TILE_H pixel multiples must rasterize
    identically to the XLA fallback (the mask uses floor-intervals of the
    bbox while the kernel once compared pixel bounds — a boundary-equality
    mismatch here would drop whole triangles at tile edges)."""
    w, h = 256, 64
    # pixel-space targets on/around the x=128 and y=32 tile seams
    px_tris = [
        # right edge exactly at x=128 (tile 0/1 seam)
        [(100.0, 10.0), (128.0, 10.0), (114.0, 30.0)],
        # left edge exactly at x=128
        [(128.0, 40.0), (156.0, 40.0), (142.0, 60.0)],
        # bottom edge exactly at y=32 (tile row seam)
        [(40.0, 12.0), (70.0, 12.0), (55.0, 32.0)],
        # vertex exactly on the tile corner (128, 32)
        [(128.0, 32.0), (150.0, 50.0), (120.0, 55.0)],
        # spans the seam
        [(120.0, 28.0), (140.0, 28.0), (130.0, 44.0)],
    ]
    tris = []
    for tri in px_tris:
        corners = []
        for (px, py) in tri:
            # inverse of the viewport transform at w=1 (z=0.5)
            x = px / w * 2.0 - 1.0
            y = 1.0 - py / h * 2.0
            corners.append([x, y, 0.5, 1.0])
        # wind so the pixel-space orientation is front-facing
        tris.append(corners)
    n = len(tris)
    clip = np.asarray(tris, np.float32)
    pad = (-n) % 256
    clip = np.concatenate([clip, np.zeros((pad, 3, 4), np.float32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    got = rasterize_pallas(
        jnp.asarray(clip), jnp.asarray(valid), w, h, cull_backface=False,
    )
    want = rasterize(
        jnp.asarray(clip), jnp.asarray(valid), w, h, cull_backface=False
    )
    assert (np.asarray(got.tri_id) == np.asarray(want.tri_id)).all()
    # every crafted triangle must actually appear (nothing dropped at seams)
    ids = set(np.unique(np.asarray(want.tri_id))) - {NO_TRIANGLE}
    assert ids == set(range(n)), ids
    np.testing.assert_allclose(
        np.asarray(got.depth), np.asarray(want.depth), atol=1e-6
    )


def test_bin_overflow_walk_all_path():
    """Force a tile's bin list over MAX_BLOCKS_PER_TILE: the kernel's
    walk-every-block fallback (count = -1) must still rasterize exactly —
    with the per-block triangle bitmasks, the overflow path indexes the
    dense mask table by raw block id, which this pins down."""
    import renderer_jax.ops.raster_pallas as rp

    w, h = 128, 64
    n = 16384  # 256 blocks of 64, twice the patched 128-block cap
    rng = np.random.default_rng(3)
    # every triangle overlaps the same tile: all blocks bin into tile 0
    base = rng.uniform(-0.9, -0.2, size=(n, 2)).astype(np.float32)
    z = rng.uniform(0.2, 0.8, size=n).astype(np.float32)
    tris = np.zeros((n, 3, 4), np.float32)
    tris[:, :, 3] = 1.0
    for k in range(3):
        tris[:, k, 0] = base[:, 0] + 0.02 * (k == 1)
        tris[:, k, 1] = base[:, 1] + 0.02 * (k == 2)
        tris[:, k, 2] = z
    clip = jnp.asarray(tris)
    valid = jnp.ones((n,), bool)
    old = rp.MAX_BLOCKS_PER_TILE
    try:
        rp.MAX_BLOCKS_PER_TILE = 128  # half the 256 blocks
        over = int(rp.bin_overflow_tiles(clip, valid, w, h, cull_backface=False))
        assert over >= 1, "setup failed to overflow any tile"
        got = rp.rasterize_pallas(
            clip, valid, w, h, cull_backface=False
        )
    finally:
        rp.MAX_BLOCKS_PER_TILE = old
    want = rasterize(clip, valid, w, h, cull_backface=False)
    assert (np.asarray(got.tri_id) == np.asarray(want.tri_id)).all()
    np.testing.assert_allclose(
        np.asarray(got.depth), np.asarray(want.depth), atol=1e-6
    )


def test_random_soups_property():
    """Property test over random triangle soups (mixed sizes, depths,
    windings, some w-crossing): Pallas tri_id/depth must match the XLA
    fallback exactly at capacities that exercise multi-block bins and the
    per-block triangle bitmasks."""
    w, h = 256, 64
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        n = 1024
        center = rng.uniform(-1.2, 1.2, size=(n, 2)).astype(np.float32)
        size = rng.uniform(0.01, 0.5, size=(n, 1)).astype(np.float32)
        z = rng.uniform(0.05, 0.95, size=(n, 1)).astype(np.float32)
        offs = rng.uniform(-1.0, 1.0, size=(n, 3, 2)).astype(np.float32)
        tris = np.zeros((n, 3, 4), np.float32)
        tris[:, :, :2] = center[:, None, :] + size[:, None, :] * offs
        tris[:, :, 2] = z
        tris[:, :, 3] = 1.0
        # a few triangles get w != 1 (perspective) and a few cross w ~ 0
        pw = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
        tris[:, :, 3] *= pw[:, None]
        tris[:, :, :3] *= pw[:, None, None]
        cross = rng.random(n) < 0.02
        tris[cross, 0, 3] = -0.1  # one vertex behind the eye
        clip = jnp.asarray(tris)
        valid = jnp.asarray(rng.random(n) < 0.9)
        for cull in (True, False):
            got = rasterize_pallas(
                clip, valid, w, h, cull_backface=cull,
                with_bary=False,
            )
            want = rasterize(clip, valid, w, h, cull_backface=cull)
            assert (np.asarray(got.tri_id) == np.asarray(want.tri_id)).all(), (
                seed, cull,
            )
            np.testing.assert_allclose(
                np.asarray(got.depth), np.asarray(want.depth), atol=1e-5
            )
