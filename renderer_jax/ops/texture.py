"""Texture sampling from the packed mip atlas — CHANNEL-FIRST.

The fragment-shader `texture(sampler2D...)` of the reference
(gltf_mesh.frag's bindless base_color[]/normal_map[] lookups) becomes batched
gather arithmetic over the packed pyramid. Each bilinear tap is ONE gather of
a uint32 RGBA word (channels unpacked with bit math), and every intermediate
is a whole 2D (H, W) plane — no temporaries with small trailing axes.
Wrap mode: repeat (the glTF default).
"""

from __future__ import annotations

import jax.numpy as jnp

from renderer_jax.scene.textures import TextureAtlas


def _level_geom(atlas: TextureAtlas, level):
    """(size, offset) for a per-pixel level array WITHOUT table gathers.

    The builder packs level l at size s_l = S >> l with all n layer slots,
    level-major (scene/textures.py:9-15), so both are closed-form:
        size(l)   = S >> l
        offset(l) = n * 4 * (S^2 - s_l^2) / 3     (geometric series, exact)
    S and n come from STATIC-index slices of the aux tables (no gather).
    At 2M pixels the two table gathers this replaces are index-rate-bound
    like any other gather — pure bit math is free by comparison."""
    s0 = atlas.level_size[0]
    size = s0 >> level
    if atlas.num_levels == 1:
        return size, jnp.zeros_like(level)
    n_slots = atlas.level_offset[1] // (s0 * s0)
    off = n_slots * (((s0 * s0 - size * size) * 4) // 3)
    return size, off


def _fetch_rgba(atlas: TextureAtlas, level, layer, x, y):
    """Integer texel fetch -> (4, ...) f32 in [0,1]. x, y pre-wrapped."""
    size, off = _level_geom(atlas, level)
    idx = off + (layer * size + y) * size + x
    word = atlas.packed_u32[idx]
    return jnp.stack(
        [
            (word & 0xFF).astype(jnp.float32),
            ((word >> 8) & 0xFF).astype(jnp.float32),
            ((word >> 16) & 0xFF).astype(jnp.float32),
            ((word >> 24) & 0xFF).astype(jnp.float32),
        ],
        axis=0,
    ) * (1.0 / 255.0)


def _bilinear(atlas: TextureAtlas, level, layer, u, v):
    """level/layer/u/v: (...,) arrays; u, v in [0,1). Returns (4, ...)."""
    size, _ = _level_geom(atlas, level)
    fs = size.astype(jnp.float32)
    tx = u * fs - 0.5
    ty = v * fs - 0.5
    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    m = size - 1  # power-of-two repeat wrap
    t00 = _fetch_rgba(atlas, level, layer, x0 & m, y0 & m)
    t10 = _fetch_rgba(atlas, level, layer, (x0 + 1) & m, y0 & m)
    t01 = _fetch_rgba(atlas, level, layer, x0 & m, (y0 + 1) & m)
    t11 = _fetch_rgba(atlas, level, layer, (x0 + 1) & m, (y0 + 1) & m)
    return (
        t00 * ((1 - fx) * (1 - fy))[None]
        + t10 * (fx * (1 - fy))[None]
        + t01 * ((1 - fx) * fy)[None]
        + t11 * (fx * fy)[None]
    )


def _gather_quad_row(atlas, idx, ncols=None):
    """One texel's QUAD_COLS row from the packed quad table.

    QUAD_PACK texels share each table row (scene/textures.py
    pack_quad_rows — GROUPED layout: all pack texels' 4 bilinear words are
    the row prefix, trilinear 3x3 words follow): gather the shared row
    (gathers are index-rate-bound, so a fuller row costs the same), then a
    log2(pack)-deep lane-select tree picks this texel's slice, at 1/pack
    the memory of one row per texel.

    ncols: only the first ncols of the texel's row are selected/returned.
    Bilinear-only sampling (ncols=4) gathers ONLY the 4*pack-lane row
    prefix — the full-width gather drags a channel-major relayout copy;
    the prefix cuts the gather output and the copy 4x."""
    from renderer_jax.scene.textures import QUAD_COLS

    if ncols is None:
        ncols = QUAD_COLS
    pack = atlas.quad_pack
    if pack == 1:
        return atlas.quad_u32[idx][..., :ncols]
    shift = pack.bit_length() - 1
    sub = idx & (pack - 1)
    if ncols <= 4:
        # bilinear-only: gather from the DEDICATED contiguous prefix table.
        # (A [:, :4*pack] slice of quad_u32 relied on XLA narrowing the
        # gather — it did for small atlases, then flipped to gathering full
        # 256 B rows at 4 layers. Materializing the
        # prefix at build time makes the narrow gather unconditional.)
        bl = atlas.quad_bl_u32
        if bl is None:
            bl = atlas.quad_u32[:, : 4 * pack]
        rows = bl[idx >> shift]  # (..., 4*pack)
        chunks = [rows[..., 4 * k : 4 * k + ncols] for k in range(pack)]
    else:
        rows = atlas.quad_u32[idx >> shift]  # (..., QUAD_COLS * pack)
        base = 4 * pack
        chunks = [
            jnp.concatenate(
                [
                    rows[..., 4 * k : 4 * k + 4],
                    rows[..., base + 12 * k : base + 12 * k + (ncols - 4)],
                ],
                axis=-1,
            )
            for k in range(pack)
        ]
    bit = 1
    while len(chunks) > 1:
        take_hi = (sub & bit)[..., None] != 0
        chunks = [
            jnp.where(take_hi, chunks[2 * k + 1], chunks[2 * k])
            for k in range(len(chunks) // 2)
        ]
        bit <<= 1
    return chunks[0]


def _sample_quad_cf(atlas, layer, u, v, lod, trilinear):
    """One-row-gather filtering via the quad table (scene/textures.py):
    each gathered row carries the level-l0 2x2 quad and the 3x3 level-l1
    neighborhood, so bilinear AND trilinear cost a single gather. Bit-exact
    with the per-tap path (same taps, same weights)."""
    n_levels = atlas.num_levels
    safe_layer = jnp.maximum(layer, 0)
    uf = u - jnp.floor(u)
    vf = v - jnp.floor(v)
    if lod is None:  # sharp mip 0: bilinear only
        lod = jnp.zeros_like(u)
        trilinear = False
    lod = jnp.clip(lod, 0.0, n_levels - 1.0)
    l0 = jnp.floor(lod).astype(jnp.int32)
    size, off = _level_geom(atlas, l0)
    fs = size.astype(jnp.float32)
    tx = uf * fs - 0.5
    ty = vf * fs - 0.5
    x0f = jnp.floor(tx)
    y0f = jnp.floor(ty)
    fx = tx - x0f
    fy = ty - y0f
    m = size - 1
    x0 = x0f.astype(jnp.int32) & m
    y0 = y0f.astype(jnp.int32) & m
    idx = off + (safe_layer * size + y0) * size + x0
    want_tri = trilinear and n_levels > 1
    rows = _gather_quad_row(
        atlas, idx, ncols=None if want_tri else 4
    )  # (..., QUAD_COLS or 4) — THE gather

    def unpack(word):
        return jnp.stack(
            [
                (word & 0xFF).astype(jnp.float32),
                ((word >> 8) & 0xFF).astype(jnp.float32),
                ((word >> 16) & 0xFF).astype(jnp.float32),
                ((word >> 24) & 0xFF).astype(jnp.float32),
            ],
            axis=0,
        ) * (1.0 / 255.0)

    out = (
        unpack(rows[..., 0]) * ((1 - fx) * (1 - fy))[None]
        + unpack(rows[..., 1]) * (fx * (1 - fy))[None]
        + unpack(rows[..., 2]) * ((1 - fx) * fy)[None]
        + unpack(rows[..., 3]) * (fx * fy)[None]
    )
    if trilinear and n_levels > 1:
        f = (lod - l0.astype(jnp.float32))[None]
        s1 = (atlas.level_size[0] >> jnp.minimum(l0 + 1, n_levels - 1)).astype(
            jnp.float32
        )
        tx1 = uf * s1 - 0.5
        ty1 = vf * s1 - 0.5
        x1f = jnp.floor(tx1)
        y1f = jnp.floor(ty1)
        fx1 = tx1 - x1f
        fy1 = ty1 - y1f
        # l1 anchor offsets within the stored 3x3 are provably in {0, 1}:
        # with t1 = t0/2 - 0.25, floor(t1) - (floor(x0/2) - 1) ∈ {0, 1}
        dx = (x1f - (jnp.floor(x0f * 0.5) - 1)).astype(jnp.int32)
        dy = (y1f - (jnp.floor(y0f * 0.5) - 1)).astype(jnp.int32)

        def tap(ddy, ddx):
            j = dy + ddy  # in {0, 1, 2}
            i = dx + ddx
            sel_row = [
                jnp.where(
                    i == 0, rows[..., 4 + 3 * jj],
                    jnp.where(i == 1, rows[..., 5 + 3 * jj], rows[..., 6 + 3 * jj]),
                )
                for jj in range(3)
            ]
            w_ = jnp.where(j == 0, sel_row[0], jnp.where(j == 1, sel_row[1], sel_row[2]))
            return unpack(w_)

        s1_out = (
            tap(0, 0) * ((1 - fx1) * (1 - fy1))[None]
            + tap(0, 1) * (fx1 * (1 - fy1))[None]
            + tap(1, 0) * ((1 - fx1) * fy1)[None]
            + tap(1, 1) * (fx1 * fy1)[None]
        )
        out = out * (1 - f) + s1_out * f
    return jnp.where((layer >= 0)[None], out, 1.0)


def sample_atlas_cf(
    atlas: TextureAtlas,
    layer: jnp.ndarray,  # (...,) i32
    u: jnp.ndarray,  # (...,) f32
    v: jnp.ndarray,  # (...,) f32
    lod: jnp.ndarray = None,  # (...,) f32 or None for sharp mip 0
    trilinear: bool = True,
) -> jnp.ndarray:
    """Channel-first RGBA sample -> (4, ...). layer < 0 returns white (the
    null-descriptor default, mirroring the reference's robustness2 reads)."""
    if atlas.quad_u32 is not None:
        return _sample_quad_cf(atlas, layer, u, v, lod, trilinear)
    n_levels = atlas.num_levels
    safe_layer = jnp.maximum(layer, 0)
    uf = u - jnp.floor(u)
    vf = v - jnp.floor(v)
    if lod is None:
        out = _bilinear(atlas, jnp.zeros_like(safe_layer), safe_layer, uf, vf)
    else:
        lod = jnp.clip(lod, 0.0, n_levels - 1.0)
        l0 = jnp.floor(lod).astype(jnp.int32)
        if trilinear:
            l1 = jnp.minimum(l0 + 1, n_levels - 1)
            f = (lod - l0.astype(jnp.float32))[None]
            s0 = _bilinear(atlas, l0, safe_layer, uf, vf)
            s1 = _bilinear(atlas, l1, safe_layer, uf, vf)
            out = s0 * (1 - f) + s1 * f
        else:
            out = _bilinear(atlas, l0, safe_layer, uf, vf)
    return jnp.where((layer >= 0)[None], out, 1.0)


def sample_atlas(
    atlas: TextureAtlas,
    layer: jnp.ndarray,  # (...,) i32
    uv: jnp.ndarray,  # (..., 2) f32
    lod: jnp.ndarray = None,
    trilinear: bool = True,
) -> jnp.ndarray:
    """Channel-last convenience wrapper -> (..., 4). Prefer sample_atlas_cf in
    hot paths (channel-first avoids tiled-layout padding)."""
    out = sample_atlas_cf(atlas, layer, uv[..., 0], uv[..., 1], lod, trilinear)
    return jnp.moveaxis(out, 0, -1)


def srgb_to_linear(c: jnp.ndarray) -> jnp.ndarray:
    """glTF base-color textures are sRGB-encoded."""
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
