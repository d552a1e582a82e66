"""Texture atlas + sampler tests."""

import numpy as np
import jax.numpy as jnp

from renderer_jax.ops.texture import sample_atlas, srgb_to_linear
from renderer_jax.scene.textures import TextureAtlasBuilder, build_mips


def test_mip_chain():
    img = np.zeros((8, 8, 4), np.uint8)
    img[:, :4] = [255, 0, 0, 255]
    img[:, 4:] = [0, 0, 255, 255]
    # the chain stops at 4x4 (packed-quad-table alignment; BC-block parity)
    mips = build_mips(img)
    assert [m.shape[0] for m in mips] == [8, 4]
    mips_full = build_mips(img, min_size=1)
    assert [m.shape[0] for m in mips_full] == [8, 4, 2, 1]
    # last mip = average color
    np.testing.assert_allclose(mips_full[-1][0, 0], [128, 0, 128, 255], atol=1)


def test_atlas_layout_and_fetch():
    b = TextureAtlasBuilder(size=8)
    solid = np.full((8, 8, 4), [10, 20, 30, 255], np.uint8)
    grad = np.zeros((8, 8, 4), np.uint8)
    grad[..., 0] = np.arange(8)[None, :] * 32  # x gradient in red
    grad[..., 3] = 255
    l0 = b.add(solid)
    l1 = b.add(grad)
    atlas = b.build()
    assert int(atlas.n_layers) == 2
    # sample at texel centers, mip 0, no filtering effects
    uv = jnp.array([[[(0.5 + 3) / 8, (0.5 + 2) / 8]]])  # texel (3,2)
    out0 = sample_atlas(atlas, jnp.array([[l0]]), uv, jnp.zeros((1, 1)))
    np.testing.assert_allclose(np.asarray(out0[0, 0, :3]), [10 / 255, 20 / 255, 30 / 255], atol=1e-3)
    out1 = sample_atlas(atlas, jnp.array([[l1]]), uv, jnp.zeros((1, 1)))
    np.testing.assert_allclose(np.asarray(out1[0, 0, 0]), 3 * 32 / 255, atol=1e-3)


def test_bilinear_interpolation():
    b = TextureAtlasBuilder(size=4)
    img = np.zeros((4, 4, 4), np.uint8)
    img[:, 0] = [0, 0, 0, 255]
    img[:, 1] = [100, 100, 100, 255]
    img[:, 2] = [200, 200, 200, 255]
    img[:, 3] = [100, 100, 100, 255]
    l = b.add(img)
    atlas = b.build()
    # halfway between texel 1 and texel 2 centers in x
    uv = jnp.array([[[(0.5 + 1.5) / 4, (0.5 + 1) / 4]]])
    out = sample_atlas(atlas, jnp.array([[l]]), uv, jnp.zeros((1, 1)))
    np.testing.assert_allclose(np.asarray(out[0, 0, 0]), 150 / 255, atol=2e-3)


def test_repeat_wrap():
    b = TextureAtlasBuilder(size=4)
    img = np.zeros((4, 4, 4), np.uint8)
    img[0, 0] = [255, 0, 0, 255]
    l = b.add(img)
    atlas = b.build()
    uv0 = jnp.array([[[0.5 / 4, 0.5 / 4]]])
    uv_wrapped = uv0 + 3.0  # repeat
    a = sample_atlas(atlas, jnp.array([[l]]), uv0, jnp.zeros((1, 1)))
    c = sample_atlas(atlas, jnp.array([[l]]), uv_wrapped, jnp.zeros((1, 1)))
    np.testing.assert_allclose(np.asarray(a), np.asarray(c), atol=1e-6)


def test_trilinear_mip_blend():
    b = TextureAtlasBuilder(size=8)
    img = np.zeros((8, 8, 4), np.uint8)
    img[::2, :] = 255  # horizontal stripes; mip1 averages to ~128
    l = b.add(img)
    atlas = b.build()
    uv = jnp.array([[[0.5, 0.5]]])
    layer = jnp.array([[l]])
    s0 = sample_atlas(atlas, layer, uv, jnp.zeros((1, 1)))
    s1 = sample_atlas(atlas, layer, uv, jnp.ones((1, 1)))
    smid = sample_atlas(atlas, layer, uv, jnp.full((1, 1), 0.5))
    expect = (np.asarray(s0) + np.asarray(s1)) / 2
    np.testing.assert_allclose(np.asarray(smid), expect, atol=1e-3)
    # lod clamped at the last level
    sbig = sample_atlas(atlas, layer, uv, jnp.full((1, 1), 99.0))
    np.testing.assert_allclose(np.asarray(sbig[0, 0, 0]), 128 / 255, atol=0.02)


def test_missing_texture_is_white():
    atlas = TextureAtlasBuilder(size=4).build()
    out = sample_atlas(atlas, jnp.array([[-1]]), jnp.array([[[0.3, 0.7]]]), jnp.zeros((1, 1)))
    np.testing.assert_allclose(np.asarray(out), 1.0)


def test_srgb_roundtrip():
    from renderer_jax.utils.image import srgb_encode

    x = np.linspace(0, 1, 64, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(srgb_to_linear(jnp.asarray(srgb_encode(x)))), x, atol=1e-5
    )


def test_quad_table_matches_tap_path():
    """The one-gather quad-table sampler must be bit-exact with the per-tap
    reference path for both filter modes, across layers/uv/lod, including
    the null (-1) layer."""
    from renderer_jax.ops.texture import sample_atlas_cf

    rng = np.random.default_rng(7)
    b = TextureAtlasBuilder(size=16)
    for _ in range(3):
        b.add(rng.integers(0, 256, size=(16, 16, 4), dtype=np.uint8))
    atlas = b.build()
    assert atlas.quad_u32 is not None
    tap_atlas = atlas._replace(quad_u32=None)

    shape = (33, 47)
    layer = jnp.asarray(rng.integers(-1, 3, size=shape), jnp.int32)
    u = jnp.asarray(rng.uniform(-1.5, 2.5, size=shape), jnp.float32)
    v = jnp.asarray(rng.uniform(-1.5, 2.5, size=shape), jnp.float32)
    lod = jnp.asarray(rng.uniform(0.0, atlas.num_levels - 0.3, size=shape), jnp.float32)
    for tri in (False, True):
        ref = np.asarray(sample_atlas_cf(tap_atlas, layer, u, v, lod, trilinear=tri))
        out = np.asarray(sample_atlas_cf(atlas, layer, u, v, lod, trilinear=tri))
        np.testing.assert_array_equal(out, ref)
    # lod=None (sharp) path too
    ref = np.asarray(sample_atlas_cf(tap_atlas, layer, u, v, None))
    out = np.asarray(sample_atlas_cf(atlas, layer, u, v, None))
    np.testing.assert_array_equal(out, ref)


def test_streamed_texture_quad_rows_refresh():
    """Streaming a texture must rewrite its layer's quad-table rows so the
    one-gather sampler sees the new texels (not the placeholder)."""
    import time

    from renderer_jax.ops.texture import sample_atlas_cf
    from renderer_jax.runtime.streaming import SceneStreamer
    from renderer_jax.scene import SceneBuilder, SceneLimits, primitives

    b = SceneBuilder(SceneLimits.tiny(), atlas_size=8)
    pl = b.add_mesh(primitives.plane())
    b.add_instance(pl, b.add_material())
    b.add_light(position=(0, -1, 0), directional=True)
    scene = b.build(texture_slots=2)
    streamer = SceneStreamer(scene, budget=2)
    img = np.zeros((8, 8, 4), np.uint8)
    img[..., 1] = 200
    img[..., 3] = 255
    layer = streamer.request_texture(img)
    for _ in range(100):
        time.sleep(0.02)
        if all(f.done() for f in streamer._pending):
            break
    streamer.pump()
    atlas = streamer.scene.atlas
    ly = jnp.full((4, 4), layer, jnp.int32)
    uv = jnp.linspace(0.1, 0.9, 4)
    out = np.asarray(
        sample_atlas_cf(atlas, ly, uv[None, :].repeat(4, 0), uv[:, None].repeat(4, 1),
                        jnp.ones((4, 4)) * 0.5, trilinear=True)
    )
    np.testing.assert_allclose(out[1], 200 / 255, atol=2e-2)
    np.testing.assert_allclose(out[0], 0.0, atol=2e-2)
    streamer.close()


def test_quad_table_packing():
    """QUAD_PACK texels share each physical 128-lane row: 4x less quad-table
    memory (the BC7-tier analogue, scene_loader.rs:318-376) and the lane
    select is bit-exact with the unpacked layout."""
    from renderer_jax.ops.texture import _gather_quad_row
    from renderer_jax.scene.textures import QUAD_COLS, QUAD_PACK

    b = TextureAtlasBuilder(size=16)
    rng = np.random.default_rng(7)
    b.add(rng.integers(0, 255, (16, 16, 4), dtype=np.uint8).astype(np.uint8))
    atlas = b.build()
    assert atlas.quad_pack == QUAD_PACK == 4
    total = atlas.packed_u32.shape[0]
    assert atlas.quad_u32.shape == (total // 4, QUAD_COLS * 4)
    # gather each texel's row through the packed layout and compare with a
    # numpy unpack of the same table (GROUPED layout: bilinear-prefix —
    # see scene/textures.py pack_quad_rows)
    q = np.asarray(atlas.quad_u32)
    bil = q[:, : 4 * 4].reshape(-1, 4, 4)
    tri = q[:, 4 * 4 :].reshape(-1, 4, QUAD_COLS - 4)
    flat = np.concatenate([bil, tri], axis=2).reshape(total, QUAD_COLS)
    idx = jnp.asarray(rng.integers(0, total, (257,), dtype=np.int32))
    rows = np.asarray(_gather_quad_row(atlas, idx))
    np.testing.assert_array_equal(rows, flat[np.asarray(idx)])
