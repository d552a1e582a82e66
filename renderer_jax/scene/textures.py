"""Texture atlas: the bindless-texture analogue.

The reference binds 2x3072 partially-bound descriptor arrays indexed by draw
id (renderer.rs:243-248, systems/textures.rs). Here descriptors don't
exist; all textures live in one packed mip-pyramid array in device memory and samplers
gather from it with a per-pixel (layer, uv, lod) — one flat address space,
which is exactly what "bindless" was approximating.

Layout: every texture is resampled to a fixed layer size S (power of two).
Mip level l holds all L layers at size s_l = S >> l, packed level-major into
one (total_texels, 4) uint8 array:

    texel(l, layer, y, x) = packed[off_l + (layer * s_l + y) * s_l + x]

so per-pixel mip selection is pure index arithmetic — no per-level branching.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TextureAtlas(NamedTuple):
    """Device-side atlas pytree. Static geometry is recoverable from shapes:
    n_layers = offsets/sizes are aux arrays.

    packed_u32 holds RGBA packed into one uint32 per texel so a bilinear tap
    is ONE gather (channel unpack is bit math on well-tiled 2D planes).

    quad_u32 (optional) is the filtering accelerator: per texel, one row
    packing the texel's 2x2 bilinear quad at its own level plus the 3x3
    level-(l+1) neighborhood that covers every possible (l+1)-level bilinear
    footprint of uvs landing in this texel. A FULL trilinear sample is then
    ONE row-gather (flat per-tap gathers are index-rate-bound, so
    fewer/wider gathers win). QUAD_PACK texels share each table row (see
    QUAD_PACK)."""

    packed_u32: "np.ndarray"  # (total_texels,) uint32, R | G<<8 | B<<16 | A<<24
    level_offset: "np.ndarray"  # (n_levels,) int32, texel offsets
    level_size: "np.ndarray"    # (n_levels,) int32, s_l
    n_layers: "np.ndarray"      # () int32
    # (total_texels // QUAD_PACK, QUAD_COLS * QUAD_PACK) u32, or None
    quad_u32: "np.ndarray" = None
    # the bilinear prefix (quad_u32[:, :4*pack]) as its OWN contiguous
    # array: bilinear-only sampling gathers from this instead of relying on
    # XLA to narrow the gather through a column slice — the compiler
    # narrowed it for small atlases but flipped to full 256 B rows when
    # the atlas grew
    quad_bl_u32: "np.ndarray" = None

    @property
    def num_levels(self) -> int:
        return self.level_size.shape[0]

    @property
    def quad_pack(self) -> int:
        return self.quad_u32.shape[1] // QUAD_COLS


# quad row columns: [q00, q10, q01, q11, n3 row-major (9)] = 13, padded to 16
QUAD_COLS = 16
# Texels per quad-table row. Packing QUAD_PACK texels per row (with the
# consumer's k-way lane select after the row gather) means fewer, fuller
# rows; on layouts that pad a (N, 16)-u32 row it also cuts quad-table
# memory QUAD_PACK-fold LOSSLESSLY. This is the answer here to the
# reference's BC7 compressed-texture tier
# (scene_loader.rs:318-376): same goal (shrink texture memory/bandwidth),
# zero quality loss. Alignment: every mip level block is 64-texel aligned
# once the chain stops at 4x4 (see build_mips min_size), so packed rows
# never straddle a level/layer boundary.
QUAD_PACK = 4
# build the quad table only when it stays under this physical budget
# quad-table device-memory budget: beyond it the sampler falls back to
# per-tap fetches (only the multi-thousand-layer reference envelope
# exceeds this at pack=8)
QUAD_TABLE_MAX_BYTES = 3 << 30  # 3 GB


def quad_rows_for_layer(mips: list, xp=np):
    """Quad rows for ONE layer from its mip images.

    mips: list of (s_l, s_l) uint32 arrays, finest first. Returns a list of
    (s_l*s_l, QUAD_COLS) uint32 row blocks, one per level. Works with numpy
    (scene build) or jax.numpy (the donated streaming upload program)."""
    n_levels = len(mips)
    out = []
    for l in range(n_levels):
        img = mips[l]
        s = img.shape[0]
        m = s - 1
        ar = xp.arange(s)
        xpw = (ar + 1) & m
        q00 = img
        q10 = img[:, xpw]
        q01 = img[xpw, :]
        q11 = img[xpw][:, xpw]
        cols = [q00, q10, q01, q11]
        if l + 1 < n_levels:
            img1 = mips[l + 1]
            s1 = img1.shape[0]
            m1 = s1 - 1
            for dy in range(3):
                yy = ((ar >> 1) - 1 + dy) & m1
                row = img1[yy]
                for dx in range(3):
                    xx = ((ar >> 1) - 1 + dx) & m1
                    cols.append(row[:, xx])
        else:
            cols += [xp.zeros((s, s), xp.uint32)] * 9
        cols += [xp.zeros((s, s), xp.uint32)] * (QUAD_COLS - len(cols))
        out.append(xp.stack(cols, axis=-1).reshape(s * s, QUAD_COLS))
    return out


def pack_quad_rows(q, pack: int, xp=np):
    """(M, QUAD_COLS) texel rows -> (M//pack, QUAD_COLS*pack) packed rows,
    GROUPED: the pack texels' 4 bilinear quad words form the row's
    contiguous prefix ([t0 w0..3, t1 w0..3, ...]), the trilinear 3x3 words
    follow ([t0 w4..15, t1 w4..15, ...]). Bilinear-only sampling then
    gathers just the 4*pack-lane prefix: with the texel-major layout the
    (P, 64) gather plus its channel-major relayout copy would be 4x
    larger."""
    if pack == 1:
        return q
    q4 = q.reshape(-1, pack, QUAD_COLS)
    bil = q4[:, :, :4].reshape(-1, pack * 4)
    tri = q4[:, :, 4:].reshape(-1, pack * (QUAD_COLS - 4))
    return xp.concatenate([bil, tri], axis=1)


def build_quad_table(
    packed_u32: np.ndarray,
    level_offset: np.ndarray,
    level_size: np.ndarray,
    n_layer_slots: int,
) -> np.ndarray:
    """(total_texels, QUAD_COLS) u32 quad table for the whole atlas (numpy,
    at scene-build time). n_layer_slots counts ALL layer slots including
    preallocated streaming slots (their rows update on upload)."""
    total = packed_u32.shape[0]
    out = np.zeros((total, QUAD_COLS), np.uint32)
    n_levels = len(level_size)
    for layer in range(n_layer_slots):
        mips = []
        for l in range(n_levels):
            s = int(level_size[l])
            start = int(level_offset[l]) + layer * s * s
            mips.append(packed_u32[start : start + s * s].reshape(s, s))
        rows = quad_rows_for_layer(mips)
        for l in range(n_levels):
            s = int(level_size[l])
            start = int(level_offset[l]) + layer * s * s
            out[start : start + s * s] = rows[l]
    return out


def _box_downsample(img: np.ndarray) -> np.ndarray:
    """(h, w, 4) u8 -> (h/2, w/2, 4) u8 box filter in float."""
    h, w, c = img.shape
    f = img.astype(np.float32).reshape(h // 2, 2, w // 2, 2, c).mean(axis=(1, 3))
    return np.clip(np.round(f), 0, 255).astype(np.uint8)


def build_mips(img: np.ndarray, min_size: int = 4) -> list:
    """Mip chain from (S, S, 4) u8 down to min_size.

    The chain stops at 4x4 (not 1x1) so every level block is 64-texel
    aligned — the invariant the packed quad table's row layout needs (and
    4x4 is the reference's BC block granularity; the 1-8 texel tail mips
    contribute nothing visible)."""
    mips = [img]
    while mips[-1].shape[0] > min_size:
        mips.append(_box_downsample(mips[-1]))
    return mips


class TextureAtlasBuilder:
    """Host-side accumulator; resizes inputs to (size, size, RGBA u8)."""

    def __init__(self, size: int = 256, max_layers: int = 64):
        assert size & (size - 1) == 0, "atlas layer size must be a power of two"
        self.size = size
        self.max_layers = max_layers
        self.layers: list[np.ndarray] = []

    def add(self, img: np.ndarray) -> int:
        """Add an (h, w, 3|4) uint8/float image; returns layer index."""
        if len(self.layers) >= self.max_layers:
            raise ValueError("texture atlas full")
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1
            )
        if img.shape[:2] != (self.size, self.size):
            from renderer_jax.utils.image import pil_image

            Image = pil_image()
            img = np.asarray(
                Image.fromarray(img).resize((self.size, self.size), Image.BILINEAR)
            )
        self.layers.append(img)
        return len(self.layers) - 1

    def build(self, preallocate: int = None) -> TextureAtlas:
        """preallocate=N reserves N layer slots (white) so textures can be
        streamed in at runtime (runtime/streaming.py request_texture)."""
        import jax.numpy as jnp

        layers = list(self.layers) or [np.full((self.size, self.size, 4), 255, np.uint8)]
        n_real = len(self.layers)  # committed layers (placeholders excluded)
        if preallocate is not None:
            while len(layers) < preallocate:
                layers.append(np.full((self.size, self.size, 4), 255, np.uint8))
        n = len(layers)
        chains = [build_mips(img) for img in layers]
        n_levels = len(chains[0])
        packed_parts = []
        offsets = []
        sizes = []
        off = 0
        for l in range(n_levels):
            s = self.size >> l
            offsets.append(off)
            sizes.append(s)
            level = np.stack([c[l] for c in chains])  # (n, s, s, 4)
            packed_parts.append(level.reshape(-1, 4))
            off += n * s * s
        packed = np.concatenate(packed_parts, axis=0)
        p32 = (
            packed[:, 0].astype(np.uint32)
            | (packed[:, 1].astype(np.uint32) << 8)
            | (packed[:, 2].astype(np.uint32) << 16)
            | (packed[:, 3].astype(np.uint32) << 24)
        )
        offsets = np.asarray(offsets, np.int32)
        sizes = np.asarray(sizes, np.int32)
        quad = None
        quad_bl = None
        pack = QUAD_PACK if p32.shape[0] % QUAD_PACK == 0 else 1
        # the budget counts a row as 512 B (a 128-lane padded row)
        # regardless of pack; pack texels share it. Large atlases switch
        # to pack=8 — (M/8, 128)-wide rows, half the bytes — because
        # losing the table entirely is far worse: the fallback samples
        # with 8 one-wide gathers/pixel.
        if (
            p32.shape[0] * 512 // pack > QUAD_TABLE_MAX_BYTES
            and p32.shape[0] % 8 == 0
        ):
            pack = 8
        if p32.shape[0] * 512 // pack <= QUAD_TABLE_MAX_BYTES:
            q = build_quad_table(p32, offsets, sizes, n)
            packed_rows = pack_quad_rows(q, pack)
            quad = jnp.asarray(packed_rows)
            quad_bl = jnp.asarray(np.ascontiguousarray(packed_rows[:, : 4 * pack]))
        return TextureAtlas(
            packed_u32=jnp.asarray(p32),
            level_offset=jnp.asarray(offsets),
            level_size=jnp.asarray(sizes),
            n_layers=jnp.asarray(np.int32(n_real)),
            quad_u32=quad,
            quad_bl_u32=quad_bl,
        )


def empty_atlas(size: int = 4) -> TextureAtlas:
    return TextureAtlasBuilder(size=size).build()
