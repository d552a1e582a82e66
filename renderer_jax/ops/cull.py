"""Draw-stream compaction: densify surviving triangles to the soup's front.

The reference compacts its indirect-draw stream on the GPU with subgroup
ballots + atomics (compact_draw_stream.comp; generate_work.comp's atomic
index append). The array-program equivalent is a masked stable compaction via
prefix sum + scatter-with-drop: one fused XLA op sequence, no atomics.

After compaction, `count` bounds the live prefix, so the rasterizer's
triangle loop runs ceil(count / block) iterations instead of the full
capacity — work scales with *visible* geometry, the reference's headline
property (SURVEY.md §5 long-context analogue).
"""

from __future__ import annotations

import jax.numpy as jnp

from renderer_jax.ops.geometry import TriangleSoup


def compact_soup(soup: TriangleSoup) -> TriangleSoup:
    """Stable-compact valid triangles to the front; returns same-capacity
    soup with a tight count. Invalid tail slots are zeroed (degenerate)."""
    valid = soup.valid
    capacity = valid.shape[0]
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1  # target slot per valid entry
    count = jnp.where(capacity > 0, pos[-1] + 1, 0).astype(jnp.int32)
    dest = jnp.where(valid, pos, capacity)  # invalid -> out of bounds

    def scatter(x):
        if x.ndim == 0:
            return x
        out = jnp.zeros_like(x)
        return out.at[dest].set(x, mode="drop")

    new_valid = jnp.arange(capacity, dtype=jnp.int32) < count
    fields = {
        name: scatter(getattr(soup, name))
        for name in soup._fields
        if name not in ("valid", "count")
    }
    return TriangleSoup(valid=new_valid, count=count, **fields)


def _morton2d(x: jnp.ndarray, y: jnp.ndarray, bits: int = 10) -> jnp.ndarray:
    """Interleave bits of x and y (each < 2^bits) -> Morton code."""

    def spread(v):
        v = v.astype(jnp.uint32)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return (spread(x) | (spread(y) << 1)).astype(jnp.uint32)


def compact_sort_soup(soup: TriangleSoup, width: int, height: int) -> TriangleSoup:
    """Fused compaction + Morton ordering: ONE argsort and ONE permutation
    move of the SoA instead of a scatter pass followed by a gather pass
    (each is a full-record move at capacity scale).

    Invalid slots get the max key, so they sort to the back: the valid
    prefix is compact AND spatially ordered."""
    key = _spatial_keys(soup, width, height)
    perm = jnp.argsort(key, stable=True)
    count = jnp.sum(soup.valid.astype(jnp.int32))
    capacity = soup.valid.shape[0]
    new_valid = jnp.arange(capacity, dtype=jnp.int32) < count

    fields = {
        name: (getattr(soup, name)[perm] if getattr(soup, name).ndim > 0 else getattr(soup, name))
        for name in soup._fields
        if name not in ("valid", "count")
    }
    return TriangleSoup(valid=new_valid, count=count, **fields)


def _spatial_keys(soup: TriangleSoup, width: int, height: int) -> jnp.ndarray:
    clip = soup.clip
    w = clip[..., 3]
    safe_w = jnp.where(jnp.abs(w) > 1e-9, w, 1e-9)
    all_front = jnp.all(w > 1e-9, axis=-1)
    px = clip[..., 0] / safe_w
    py = clip[..., 1] / safe_w
    cx = jnp.clip((jnp.min(px, -1) + jnp.max(px, -1)) * 0.25 + 0.5, 0.0, 1.0)
    cy = jnp.clip((jnp.min(py, -1) + jnp.max(py, -1)) * -0.25 + 0.5, 0.0, 1.0)
    gx = jnp.where(all_front, (cx * 1023).astype(jnp.uint32), 0)
    gy = jnp.where(all_front, (cy * 1023).astype(jnp.uint32), 0)
    key = _morton2d(gx, gy)
    return jnp.where(soup.valid, key, jnp.uint32(0xFFFFFFFF))


def sort_soup_spatial(soup: TriangleSoup, width: int, height: int) -> TriangleSoup:
    """Reorder the (compacted) soup by the Morton code of each triangle's
    screen-bbox center.

    The Pallas rasterizer bins triangles at DMA-block granularity; after
    draw-stream expansion, consecutive triangles belong to consecutive
    *instances*, which sit at random screen positions, so block bboxes are
    loose. A Morton sort makes blocks spatially coherent, which tightens
    block bboxes to near per-triangle binning quality. Invalid slots sort to
    the end (key = max), preserving the compact prefix. ~one 32-bit sort of
    the capacity per frame (cheap relative to raster).

    This is the analogue of the tile binning in CuRast-style software
    rasterizers (PAPERS.md). Prefer compact_sort_soup (fused) in pipelines.
    """
    key = _spatial_keys(soup, width, height)
    perm = jnp.argsort(key, stable=True)

    def apply(x):
        return x[perm] if x.ndim > 0 else x

    fields = {
        name: apply(getattr(soup, name))
        for name in soup._fields
        if name != "count"
    }
    return TriangleSoup(count=soup.count, **fields)
