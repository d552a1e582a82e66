"""Binned tile rasterizer — the hot kernel (ops/raster_spec.py semantics).

Replaces the fixed-function rasterizer + early-z the reference gets from the
GPU hardware (and its per-triangle cull kernel generate_work.comp) with a
software tile rasterizer written in Pallas for the Triton route:

- The framebuffer is processed in (TILE_H x TILE_W) = (16 x 64) pixel
  tiles, one Triton program each. The depth/id accumulators live in
  registers for the whole tile (no read-modify-write of device memory per
  triangle, the software analogue of tiled ROPs). A 1920x1088 frame is 2040
  programs, about 15 per SM on an H100.
- Triangle setup (oriented edge functions, z/w, fill-rule flags) is
  computed by XLA into one (T, ROWS) record table; each record is one
  128-byte row, so a triangle's scalar reads hit one cache line.
- Binning: per tile and per 64-triangle block, a 64-bit mask of the
  triangles whose bbox tile-interval contains the tile, and per tile the
  ascending list of blocks with a nonzero mask. The kernel walks the list
  and, inside a block, only the SET bits of the mask (lowest first, so
  triangles are visited in ascending id order and depth ties resolve as in
  the reference rasterizer): work scales with coverage, not scene size.
- Per visited triangle: three edge functions on the pixel tile, the exact
  top-left fill rule, perspective z as a rational z_num/w, depth-test
  select.
- Row shards: y0/full_height render a horizontal slice of a larger
  framebuffer for multi-device split-frame rendering (renderer_jax.parallel).

The kernel route follows the backend (kernel_route): Triton on the GPU, the
Pallas interpreter on the CPU (the test route), an error elsewhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from renderer_jax.ops.raster_jax import VisibilityBuffer
from renderer_jax.ops.raster_spec import DEPTH_CLEAR, FRONT_DET_SIGN, NO_TRIANGLE

# Tile shape: powers of two (Triton blocks), TILE_H divides the 1088-row
# bench frame and its 272-row quarter (the 4-device SPMD row shard).
TILE_H = 16
TILE_W = 64
NUM_WARPS = 4  # 128 threads -> 8 pixels per thread per accumulator
# Triangles per bin unit: one 64-bit mask (two i32 words) per (tile, block).
BLOCK = 64
# f32 record columns per triangle: 18 used, padded to 32 so a record is one
# aligned 128-byte line
ROWS = 32
_R_E = 0      # cols 0..8: oriented edge coeffs (e0a,e0b,e0c, e1a,..., e2c)
_R_Z = 9      # cols 9..11: z_clip per vertex
_R_W = 12     # cols 12..14: w_clip per vertex
# cols 15..17: per-edge fill-rule tie value. The top-left rule is
# "lam > 0 or (lam == 0 and top_left)"; storing 0.0 for top-left edges and
# NaN otherwise makes it "lam > 0 or lam == tie" — exact whether or not
# the device flushes subnormals (NaN compares unequal to everything).
_R_TIE = 15

MAX_BLOCKS_PER_TILE = 2048  # per-tile bin list cap (list memory bound)


def kernel_route(backend: str | None = None) -> dict:
    """pallas_call keyword arguments for the backend's kernel route.

    gpu: compile through Triton. cpu: run in the Pallas interpreter (the
    test route, and the only place interpret mode runs). Any other backend
    has no route and raises."""
    backend = backend or jax.default_backend()
    if backend == "gpu":
        return {
            "compiler_params": plt.CompilerParams(
                num_warps=NUM_WARPS, num_stages=1
            )
        }
    if backend == "cpu":
        return {"interpret": True}
    raise NotImplementedError(
        f"no Pallas kernel route for backend {backend!r} (gpu or cpu)"
    )


def _setup_tri_data(clip, valid, width, height, cull_backface):
    """Triangle setup -> (tri_data (T, ROWS), bbox_ok for the binner).

    Column math over (T,) vectors, the same expressions as
    ops/raster_spec.py's pixel_homogeneous()/adjugate, term by term."""
    t_cap = clip.shape[0]
    x = [clip[:, c, 0] for c in range(3)]
    y = [clip[:, c, 1] for c in range(3)]
    zs = [clip[:, c, 2] for c in range(3)]
    ws = [clip[:, c, 3] for c in range(3)]
    ux = [(x[c] + ws[c]) * (0.5 * width) for c in range(3)]
    uy = [(ws[c] - y[c]) * (0.5 * height) for c in range(3)]
    uz = ws

    def cross(a_i, b_i):
        """adjugate row = cross of the other two pixel-homogeneous corners
        (identical products to geometry.adjugate3)."""
        return (
            uy[a_i] * uz[b_i] - uz[a_i] * uy[b_i],
            uz[a_i] * ux[b_i] - ux[a_i] * uz[b_i],
            ux[a_i] * uy[b_i] - uy[a_i] * ux[b_i],
        )

    adj_rows = [cross(1, 2), cross(2, 0), cross(0, 1)]  # e0, e1, e2
    det = (
        ux[0] * (uy[1] * uz[2] - uy[2] * uz[1])
        - ux[1] * (uy[0] * uz[2] - uy[2] * uz[0])
        + ux[2] * (uy[0] * uz[1] - uy[1] * uz[0])
    )
    if cull_backface:
        sgn = jnp.float32(FRONT_DET_SIGN)
        ok = valid & (det * FRONT_DET_SIGN > 0)
    else:
        sgn = jnp.sign(det)
        ok = valid & (det != 0)
    adj_rows = [tuple(comp * sgn for comp in row) for row in adj_rows]

    all_front = (ws[0] > 1e-9) & (ws[1] > 1e-9) & (ws[2] > 1e-9)
    safe_w = [jnp.where(jnp.abs(w) > 1e-9, w, 1e-9) for w in ws]
    px = [ux[c] / safe_w[c] for c in range(3)]
    py = [uy[c] / safe_w[c] for c in range(3)]

    def min3(v):
        return jnp.minimum(jnp.minimum(v[0], v[1]), v[2])

    def max3(v):
        return jnp.maximum(jnp.maximum(v[0], v[1]), v[2])

    xmin = jnp.where(all_front, min3(px) - 0.5, 0.0)
    xmax = jnp.where(all_front, max3(px) + 0.5, float(width))
    ymin = jnp.where(all_front, min3(py) - 0.5, 0.0)
    ymax = jnp.where(all_front, max3(py) + 0.5, float(height))
    # clip the bbox so off-screen tris never flag any tile
    on_screen = (xmax >= 0) & (xmin <= width) & (ymax >= 0) & (ymin <= height)
    ok = ok & on_screen

    tie = [
        jnp.where(
            (row[0] > 0) | ((row[0] == 0) & (row[1] > 0)),
            jnp.float32(0.0),
            jnp.float32(jnp.nan),
        )
        for row in adj_rows
    ]
    cols = (
        [comp for row in adj_rows for comp in row]  # 0..8  e0abc,e1abc,e2abc
        + list(zs)  # 9..11
        + list(ws)  # 12..14
        + tie  # 15..17
    )
    cols += [jnp.zeros((t_cap,), jnp.float32)] * (ROWS - len(cols))
    tri_data = jnp.stack(cols, axis=-1)  # (T, ROWS)
    return tri_data, (xmin, xmax, ymin, ymax, ok)


def _bin_blocks(bbox_ok, t_cap, width, height, y0=0, tile_bboxes=None):
    """Block-granularity binning: per tile, the ascending list of triangle
    blocks whose bbox union overlaps the tile (with counts).

    A tile overlapping more than the list width gets the sentinel count
    -1 = "walk every block" (correct, just unbinned).

    tile_bboxes: optional (t_x0, t_x1, t_y0, t_y1) arrays of shape
    (n_ty, n_tx) replacing the regular pixel-grid tile extents — used by the
    light-space occlusion kernel, where each SCREEN tile covers a
    data-dependent LIGHT-space bbox."""
    xmin, xmax, ymin, ymax, ok = bbox_ok
    n_blocks = t_cap // BLOCK
    inf = jnp.float32(jnp.inf)
    bxmin = jnp.min(jnp.where(ok, xmin, inf).reshape(n_blocks, BLOCK), axis=1)
    bxmax = jnp.max(jnp.where(ok, xmax, -inf).reshape(n_blocks, BLOCK), axis=1)
    bymin = jnp.min(jnp.where(ok, ymin, inf).reshape(n_blocks, BLOCK), axis=1)
    bymax = jnp.max(jnp.where(ok, ymax, -inf).reshape(n_blocks, BLOCK), axis=1)
    bany = jnp.any(ok.reshape(n_blocks, BLOCK), axis=1)

    n_ty = height // TILE_H
    n_tx = width // TILE_W
    if tile_bboxes is None:
        ty = jnp.arange(n_ty, dtype=jnp.float32)[:, None, None]
        tx = jnp.arange(n_tx, dtype=jnp.float32)[None, :, None]
        t_x0, t_x1 = tx * TILE_W, (tx + 1) * TILE_W
        y0f = jnp.asarray(y0, jnp.float32)
        t_y0, t_y1 = y0f + ty * TILE_H, y0f + (ty + 1) * TILE_H
    else:
        t_x0, t_x1, t_y0, t_y1 = (b[..., None] for b in tile_bboxes)
    overlap = (
        bany[None, None, :]
        & (bxmin[None, None, :] <= t_x1)
        & (bxmax[None, None, :] >= t_x0)
        & (bymin[None, None, :] <= t_y1)
        & (bymax[None, None, :] >= t_y0)
    )  # (n_ty, n_tx, n_blocks)
    return _compact_lists(overlap.reshape(-1, n_blocks))


def _compact_lists(flat):
    """(n_tiles, n_blocks) bool -> (ascending block lists (n_tiles, maxb),
    counts (n_tiles,) with -1 where the list overflowed maxb).

    A stable argsort on the negated bit puts the set ids first, ascending;
    entries past a tile's count are ids with a clear bit."""
    n_blocks = flat.shape[1]
    maxb = min(n_blocks, MAX_BLOCKS_PER_TILE)
    block_count = jnp.sum(flat, axis=1, dtype=jnp.int32)
    block_list = jnp.argsort(~flat, axis=1, stable=True)[:, :maxb]
    block_count = jnp.where(block_count > maxb, -1, block_count)
    return block_list.astype(jnp.int32), block_count


def _bin_tri_masks(bbox_ok, t_cap, width, height, y0=0):
    """Per-(tile, block) 64-bit triangle masks -> (n_tiles, 2*n_blocks) i32
    ([2b] = bits for triangles 64b..64b+31, [2b+1] = 64b+32..64b+63).

    Bit k is set iff triangle 64b+k's bbox tile-interval contains the tile —
    conservative for actual coverage (covered pixel centers lie inside
    [xmin, xmax] x [ymin, ymax], so their tile indices lie inside the
    floor-interval). A triangle's tile set is a rectangle of tile coords,
    so the (n_tiles, T) bit matrix is the outer AND of a row factor
    (n_ty, T) and a column factor (n_tx, T); XLA fuses that AND into the
    32-bit word reduction, so the bit matrix never reaches memory."""
    xmin, xmax, ymin, ymax, ok = bbox_ok
    n_ty, n_tx = height // TILE_H, width // TILE_W
    y0f = jnp.asarray(y0, jnp.float32)
    # NaN bboxes always have ok == False (their on-screen compare fails);
    # dead triangles get the empty x interval
    txi0 = jnp.where(ok, jnp.floor(xmin * (1.0 / TILE_W)), float(n_tx))
    txi1 = jnp.where(ok, jnp.floor(xmax * (1.0 / TILE_W)), -1.0)
    tyi0 = jnp.floor((ymin - y0f) * (1.0 / TILE_H))
    tyi1 = jnp.floor((ymax - y0f) * (1.0 / TILE_H))
    ty_v = jnp.arange(n_ty, dtype=jnp.float32)[:, None]
    tx_v = jnp.arange(n_tx, dtype=jnp.float32)[:, None]
    oy = (tyi0[None] <= ty_v) & (ty_v <= tyi1[None])  # (n_ty, T)
    ox = (txi0[None] <= tx_v) & (tx_v <= txi1[None])  # (n_tx, T)
    bits = oy[:, None, :] & ox[None, :, :]  # (n_ty, n_tx, T)
    shifts = jnp.arange(32, dtype=jnp.int32)
    words = jnp.sum(
        jnp.left_shift(bits.reshape(n_ty, n_tx, t_cap // 32, 32).astype(jnp.int32),
                       shifts),
        axis=-1, dtype=jnp.int32,
    )  # distinct bits: the wrapping sum is their OR
    return words.reshape(n_ty * n_tx, t_cap // 32)


def _bin_blocks_from_masks(masks, n_blocks):
    """Per-tile block lists derived from the per-triangle bit masks: a
    block belongs in a tile's list iff its 64-bit mask is nonzero (tighter
    than a block bbox-union overlap)."""
    w0 = masks[:, 0 : 2 * n_blocks : 2]  # (n_tiles, n_blocks)
    w1 = masks[:, 1 : 2 * n_blocks : 2]
    return _compact_lists((w0 | w1) != 0)


def _set_bits(word, fn, carry):
    """fn(k, carry) for every set bit k of the i32 `word`, lowest first."""

    def body(c):
        w, carry = c[0], c[1:]
        low = w & -w
        carry = fn(31 - jax.lax.clz(low), carry)
        return (w ^ low, *carry)

    return jax.lax.while_loop(lambda c: c[0] != 0, body, (word, *carry))[1:]


def _raster_kernel(
    n_blocks: int,
    with_bary: bool,
    y0_ref,     # (1,) i32 row offset (sharded-image support)
    count_ref,  # (n_tiles,) i32; -1 = bin overflow, walk all blocks
    list_ref,   # (n_tiles, maxb) i32 ascending block ids
    mask_ref,   # (n_tiles, 2*n_blocks) i32 per-block 64-bit tri masks
    tri_ref,    # (T, ROWS) f32 records
    depth_ref,  # (TILE_H, TILE_W) f32 output block
    id_ref,     # (TILE_H, TILE_W) i32
    *bary_refs,  # with_bary: b0, b1 (TILE_H, TILE_W) f32
):
    ty = pl.program_id(0)
    tx = pl.program_id(1)
    tile = ty * pl.num_programs(1) + tx
    maxb = list_ref.shape[1]
    raw_count = count_ref[tile]
    overflow = raw_count < 0
    count = jnp.where(overflow, n_blocks, raw_count)

    shape = (TILE_H, TILE_W)
    px = (
        jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        + tx * TILE_W
    ).astype(jnp.float32) + 0.5
    py = (
        jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        + ty * TILE_H + y0_ref[0]
    ).astype(jnp.float32) + 0.5

    def tri(t, acc):
        def s(col):
            return tri_ref[t, col]

        def edge(e):
            lam = s(_R_E + 3 * e) * px + s(_R_E + 3 * e + 1) * py + s(_R_E + 3 * e + 2)
            return lam, (lam > 0.0) | (lam == s(_R_TIE + e))

        lam0, a0 = edge(0)
        lam1, a1 = edge(1)
        lam2, a2 = edge(2)
        w_i = lam0 * s(_R_W) + lam1 * s(_R_W + 1) + lam2 * s(_R_W + 2)
        z_num = lam0 * s(_R_Z) + lam1 * s(_R_Z + 1) + lam2 * s(_R_Z + 2)
        # depth is tracked as a rational z_num/w (w > 0 for every covered
        # pixel): z in [0,1] and the depth test are divide-free —
        #   z >= 0 <=> z_num >= 0;  z <= 1 <=> z_num <= w_i;
        #   z < z_ref <=> z_num * w_ref < z_ref_num * w_i
        covered = a0 & a1 & a2 & (w_i > 0) & (z_num >= 0.0) & (z_num <= w_i)
        znum, wden, ids = acc[:3]
        closer = covered & (z_num * wden < znum * w_i)
        out = (
            jnp.where(closer, z_num, znum),
            jnp.where(closer, w_i, wden),
            jnp.where(closer, t, ids),
        )
        if with_bary:
            l0, l1, ls = acc[3:]
            out += (
                jnp.where(closer, lam0, l0),
                jnp.where(closer, lam1, l1),
                jnp.where(closer, lam0 + lam1 + lam2, ls),
            )
        return out

    def visit(i, acc):
        blk = jnp.where(overflow, i, list_ref[tile, jnp.minimum(i, maxb - 1)])
        base = blk * BLOCK
        acc = _set_bits(mask_ref[tile, 2 * blk], lambda k, a: tri(base + k, a), acc)
        return _set_bits(
            mask_ref[tile, 2 * blk + 1], lambda k, a: tri(base + 32 + k, a), acc
        )

    init = (
        jnp.full(shape, DEPTH_CLEAR, jnp.float32),
        jnp.ones(shape, jnp.float32),
        jnp.full(shape, NO_TRIANGLE, jnp.int32),
    )
    if with_bary:
        init += (
            jnp.zeros(shape, jnp.float32),
            jnp.zeros(shape, jnp.float32),
            jnp.ones(shape, jnp.float32),
        )
    acc = jax.lax.fori_loop(0, count, visit, init)
    depth_ref[...] = acc[0] / acc[1]  # wden >= min(1, w_i) > 0
    id_ref[...] = acc[2]
    if with_bary:
        b0_ref, b1_ref = bary_refs
        inv = 1.0 / jnp.where(acc[5] != 0.0, acc[5], 1.0)
        b0_ref[...] = acc[3] * inv
        b1_ref[...] = acc[4] * inv


@functools.partial(jax.jit, static_argnames=("width", "height", "cull_backface"))
def bin_overflow_tiles(
    clip: jnp.ndarray, valid: jnp.ndarray, width: int, height: int,
    cull_backface: bool = True,
) -> jnp.ndarray:
    """() i32 — tiles whose bin list overflowed MAX_BLOCKS_PER_TILE this
    frame (those tiles silently degrade to walk-all-blocks: correct but a
    perf cliff; surfaced in the HUD so it's observable)."""
    _, bbox_ok = _setup_tri_data(clip, valid, width, height, cull_backface)
    masks = _bin_tri_masks(bbox_ok, clip.shape[0], width, height)
    _, block_count = _bin_blocks_from_masks(masks, clip.shape[0] // BLOCK)
    return jnp.sum((block_count < 0).astype(jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "cull_backface", "full_height", "with_bary"),
)
def rasterize_pallas(
    clip: jnp.ndarray,
    valid: jnp.ndarray,
    width: int,
    height: int,
    cull_backface: bool = True,
    count=None,  # accepted for API parity; binning already skips dead blocks
    y0=0,  # may be traced: render rows [y0, y0+height) of a full_height image
    full_height: int = None,
    with_bary: bool = True,  # False: depth+id only (bary re-derived in shade)
) -> VisibilityBuffer:
    """Drop-in replacement for ops.raster_jax.rasterize (same spec/outputs).

    Requires width % TILE_W == 0, height % TILE_H == 0 and T % BLOCK == 0.
    y0/full_height support row-sharded framebuffers (renderer_jax.parallel).
    With with_bary=False the barycentrics are not computed: bary is
    (0, 0, 1) on covered pixels.
    """
    del count
    if full_height is None:
        full_height = height
    t_cap = clip.shape[0]
    assert t_cap % BLOCK == 0, (t_cap, BLOCK)
    assert width % TILE_W == 0 and height % TILE_H == 0, (width, height)
    n_ty, n_tx = height // TILE_H, width // TILE_W
    n_blocks = t_cap // BLOCK

    tri_data, bbox_ok = _setup_tri_data(
        clip, valid, width, full_height, cull_backface
    )
    # tile grid covers only this shard's rows, offset by y0 in pixel space
    masks = _bin_tri_masks(bbox_ok, t_cap, width, height, y0=y0)
    block_list, block_count = _bin_blocks_from_masks(masks, n_blocks)

    tile_spec = pl.BlockSpec((TILE_H, TILE_W), lambda ty, tx: (ty, tx))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    n_out = 4 if with_bary else 2
    out_shape = [
        jax.ShapeDtypeStruct((height, width), jnp.float32),
        jax.ShapeDtypeStruct((height, width), jnp.int32),
    ] + [jax.ShapeDtypeStruct((height, width), jnp.float32)] * (n_out - 2)
    outs = pl.pallas_call(
        functools.partial(_raster_kernel, n_blocks, with_bary),
        grid=(n_ty, n_tx),
        in_specs=[whole] * 5,
        out_specs=[tile_spec] * n_out,
        out_shape=out_shape,
        name="raster_tiles",
        **kernel_route(),
    )(
        jnp.asarray(y0, jnp.int32).reshape(1),
        block_count,
        block_list,
        masks,
        tri_data,
    )
    depth, tri_id = outs[0], outs[1]
    covered = tri_id != NO_TRIANGLE
    if with_bary:
        b0, b1 = outs[2], outs[3]
        bary = jnp.stack([b0, b1, 1.0 - b0 - b1], axis=0)  # channel-first
        bary = jnp.where(covered[None], bary, 0.0)
    else:
        zero = jnp.zeros((height, width), jnp.float32)
        bary = jnp.stack([zero, zero, covered.astype(jnp.float32)], axis=0)
    return VisibilityBuffer(depth=depth, tri_id=tri_id, bary=bary)
