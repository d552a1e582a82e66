"""Accelerated ray-traced shadows: light-space 2D binning + Pallas traversal.

The reference builds per-mesh BLASes and a per-frame TLAS and ray-queries
them in the fragment shader (acceleration_strucures.rs:221-569,
gltf_mesh.frag:136-160). For DIRECTIONAL lights every shadow ray is
parallel, so the whole query projects to 2D light space: receiver
(x, y, depth) is occluded iff some caster triangle covers (x, y) with
smaller light depth. The acceleration structure is therefore a light-space
triangle binning — the 2D analogue of a TLAS for parallel rays — and the
"traversal" is a Pallas kernel (Triton route, kernel_route) that walks, per
SCREEN tile, only the triangle blocks whose light-space bbox overlaps that
tile's RECEIVER bbox (data-dependent tiles: the screen->light mapping is
continuous, so screen tiles cover compact light-space regions).

Unlike a shadow map there is no resolution or bias-texel error: coverage is
analytic point-in-triangle at each receiver's exact light-space position —
the same answer ray casting gives, at raster-like cost. Casters are
expanded PER LIGHT (expand_clip_only against the light frustum), so
off-camera geometry occludes correctly — exceeding the camera-culled brute
force path (ops/rt.py). occlusion_dense is the plain-XLA evaluation of the
same per-light occlusion over the same caster stream: the kernel's
reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from renderer_jax.ops.raster_pallas import (
    BLOCK,
    TILE_H,
    TILE_W,
    _bin_blocks,
    kernel_route,
)

# record columns (light-space, 2D homogeneous — handles perspective lights)
_O_E = 0    # 0..8   edge coeffs (sign-normalized: inside => all lam >= 0)
_O_Z = 9    # 9..11  z_clip per vertex (rational depth z = z_num / w_den)
_O_W = 12   # 12..14 w_clip per vertex
_O_BB = 15  # 15..18 light NDC bbox (xmin, xmax, ymin, ymax); +inf/-inf
#                    for dead triangles, so the bbox test rejects them
ROWS = 19


def _setup_light_tris(clip, valid):
    """Light-clip triangles -> (tri_data (T, ROWS), bbox_ok for binning).

    2D-homogeneous (clipless) formulation — the same math as the camera
    rasterizer (ops/raster_spec.py): edge functions are cross products of
    the clip-space (x, y, w) columns and depth is the rational
    z_num/w_den, so PERSPECTIVE lights (point-light cube faces) work
    without near-plane clipping; for orthographic lights (w == 1) this
    reduces exactly to the 2D case."""
    x = clip[..., 0]  # (T, 3)
    y = clip[..., 1]
    z = clip[..., 2]
    w = clip[..., 3]

    def cross_cols(ax, ay, aw, bx, by, bw):
        return (ay * bw - aw * by, aw * bx - ax * bw, ax * by - ay * bx)

    e0 = cross_cols(x[:, 1], y[:, 1], w[:, 1], x[:, 2], y[:, 2], w[:, 2])
    e1 = cross_cols(x[:, 2], y[:, 2], w[:, 2], x[:, 0], y[:, 0], w[:, 0])
    e2 = cross_cols(x[:, 0], y[:, 0], w[:, 0], x[:, 1], y[:, 1], w[:, 1])
    det = e0[0] * x[:, 0] + e0[1] * y[:, 0] + e0[2] * w[:, 0]
    sgn = jnp.sign(det)
    ok = valid & (det != 0)

    # NDC bbox; w-crossing triangles get the full screen (clipless rule)
    all_front = jnp.all(w > 1e-9, axis=1)
    safe_w = jnp.where(jnp.abs(w) > 1e-9, w, 1e-9)
    px = x / safe_w
    py = y / safe_w
    xmin = jnp.where(all_front, jnp.min(px, axis=1), -2.0)
    xmax = jnp.where(all_front, jnp.max(px, axis=1), 2.0)
    ymin = jnp.where(all_front, jnp.min(py, axis=1), -2.0)
    ymax = jnp.where(all_front, jnp.max(py, axis=1), 2.0)

    inf = jnp.float32(jnp.inf)
    cols = [c * sgn for e in (e0, e1, e2) for c in e]
    cols += [z[:, 0], z[:, 1], z[:, 2], w[:, 0], w[:, 1], w[:, 2]]
    cols += [
        jnp.where(ok, xmin, inf), jnp.where(ok, xmax, -inf),
        jnp.where(ok, ymin, inf), jnp.where(ok, ymax, -inf),
    ]
    tri_data = jnp.stack(cols, axis=-1)  # (T, ROWS)
    return tri_data, (xmin, xmax, ymin, ymax, ok)


def _occluded(rec, lx, ly, ld):
    """Occlusion of receivers (lx, ly, ld) by one caster record `rec`
    (callable col -> value): inside the three edge half-planes, in front
    of the light (w_den > 0) and strictly closer to it. Depth is rational
    (divide-free): the caster occludes iff z_num/w_den < ld."""
    lam = [
        rec(_O_E + 3 * e) * lx + rec(_O_E + 3 * e + 1) * ly + rec(_O_E + 3 * e + 2)
        for e in range(3)
    ]
    z_num = lam[0] * rec(_O_Z) + lam[1] * rec(_O_Z + 1) + lam[2] * rec(_O_Z + 2)
    w_den = lam[0] * rec(_O_W) + lam[1] * rec(_O_W + 1) + lam[2] * rec(_O_W + 2)
    return (
        (lam[0] >= 0) & (lam[1] >= 0) & (lam[2] >= 0)
        & (w_den > 0) & (z_num < ld * w_den)
    )


def _occlusion_kernel(
    n_blocks: int,
    count_ref,      # (n_tiles,) i32; -1 = bin overflow, walk all blocks
    tile_bbox_ref,  # (n_tiles, 4) f32 receiver light bbox per tile
    list_ref,       # (n_tiles, maxb) i32 ascending block ids
    tri_ref,        # (T, ROWS) f32 records
    lx_ref,         # (TILE_H, TILE_W) receiver light x
    ly_ref,
    ld_ref,         # receiver light depth (+inf for background)
    occ_ref,        # (TILE_H, TILE_W) f32 output: 1 lit, 0 occluded
):
    tile = pl.program_id(0) * pl.num_programs(1) + pl.program_id(1)
    maxb = list_ref.shape[1]
    raw_count = count_ref[tile]
    overflow = raw_count < 0
    count = jnp.where(overflow, n_blocks, raw_count)
    lx = lx_ref[...]
    ly = ly_ref[...]
    ld = ld_ref[...]
    rx0 = tile_bbox_ref[tile, 0]
    rx1 = tile_bbox_ref[tile, 1]
    ry0 = tile_bbox_ref[tile, 2]
    ry1 = tile_bbox_ref[tile, 3]

    def visit(i, occ):
        blk = jnp.where(overflow, i, list_ref[tile, jnp.minimum(i, maxb - 1)])

        def tri(k, occ):
            t = blk * BLOCK + k

            def rec(col):
                return tri_ref[t, col]

            # the tile's receiver bbox against the caster's: one scalar
            # test skips the tile's pixel work for most block members
            hit_tile = (
                (rec(_O_BB) <= rx1) & (rec(_O_BB + 1) >= rx0)
                & (rec(_O_BB + 2) <= ry1) & (rec(_O_BB + 3) >= ry0)
            )
            return jax.lax.cond(
                hit_tile,
                lambda o: jnp.where(_occluded(rec, lx, ly, ld), 0.0, o),
                lambda o: o,
                occ,
            )

        return jax.lax.fori_loop(0, BLOCK, tri, occ)

    occ_ref[...] = jax.lax.fori_loop(
        0, count, visit, jnp.ones((TILE_H, TILE_W), jnp.float32)
    )


def _pad_to_tiles(a, fill):
    """Pad (H, W) up to (TILE_H, TILE_W) multiples (reduced-res grids)."""
    h, w = a.shape
    ph = (-h) % TILE_H
    pw = (-w) % TILE_W
    if ph == 0 and pw == 0:
        return a
    return jnp.pad(a, ((0, ph), (0, pw)), constant_values=fill)


@jax.jit
def occlusion_grid(
    clip: jnp.ndarray,    # (T, 3, 4) caster triangles in LIGHT clip space
    valid: jnp.ndarray,   # (T,)
    lx: jnp.ndarray,      # (H, W) receiver light-space x (NDC)
    ly: jnp.ndarray,      # (H, W)
    ld: jnp.ndarray,      # (H, W) receiver light depth (biased; +inf = skip)
) -> jnp.ndarray:
    """(H, W) f32 occlusion: 1 lit, 0 shadowed. Exact analytic coverage.

    Grids that are not tile multiples (reduced-resolution rt tiers) are
    padded with ld=+inf receivers — padded tiles have empty receiver
    bboxes and walk zero caster blocks."""
    h0, w0 = lx.shape
    if h0 % TILE_H or w0 % TILE_W:
        lx = _pad_to_tiles(lx, 0.0)
        ly = _pad_to_tiles(ly, 0.0)
        ld = _pad_to_tiles(ld, jnp.inf)
    h, w = lx.shape
    t_cap = clip.shape[0]
    assert t_cap % BLOCK == 0, (t_cap, BLOCK)
    n_ty, n_tx = h // TILE_H, w // TILE_W
    n_blocks = t_cap // BLOCK

    tri_data, bbox_ok = _setup_light_tris(clip, valid)

    # per-tile receiver bboxes in light space (background pixels excluded)
    live = jnp.isfinite(ld)
    big = jnp.float32(3e38)

    def tile_reduce(v, fn, fill):
        t = jnp.where(live, v, fill).reshape(n_ty, TILE_H, n_tx, TILE_W)
        return fn(t, axis=(1, 3))

    tx0 = tile_reduce(lx, jnp.min, big)
    tx1 = tile_reduce(lx, jnp.max, -big)
    ty0 = tile_reduce(ly, jnp.min, big)
    ty1 = tile_reduce(ly, jnp.max, -big)

    block_list, block_count = _bin_blocks(
        bbox_ok, t_cap, w, h, tile_bboxes=(tx0, tx1, ty0, ty1)
    )
    tile_bbox = jnp.stack(
        [tx0.reshape(-1), tx1.reshape(-1), ty0.reshape(-1), ty1.reshape(-1)], -1
    )

    tile_spec = pl.BlockSpec((TILE_H, TILE_W), lambda ty, tx: (ty, tx))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    occ = pl.pallas_call(
        functools.partial(_occlusion_kernel, n_blocks),
        grid=(n_ty, n_tx),
        in_specs=[whole] * 4 + [tile_spec] * 3,
        out_specs=tile_spec,
        out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32),
        name="rt_occlusion_tiles",
        **kernel_route(),
    )(block_count, tile_bbox, block_list, tri_data, lx, ly, ld)
    return occ[:h0, :w0]


@functools.partial(jax.jit, static_argnames=("tri_block",))
def occlusion_dense(clip, valid, lx, ly, ld, tri_block: int = 256):
    """Plain-XLA occlusion_grid: every live caster against every receiver,
    no binning (the kernel's reference, same (H, W) 1 lit / 0 shadowed)."""
    tri_data, bbox_ok = _setup_light_tris(clip, valid)
    t_cap = tri_data.shape[0]
    tri_block = min(tri_block, t_cap)
    blocks = tri_data.reshape(t_cap // tri_block, tri_block, ROWS)
    live = bbox_ok[4].reshape(t_cap // tri_block, tri_block)

    def body(lit, blk_live):
        blk, ok = blk_live
        hit = _occluded(
            lambda col: blk[:, col][:, None, None], lx[None], ly[None], ld[None]
        )
        return lit & ~jnp.any(hit & ok[:, None, None], axis=0), None

    lit, _ = jax.lax.scan(body, jnp.ones(lx.shape, bool), (blocks, live))
    return lit.astype(jnp.float32)


def _bilateral_upsample(low, tri_lo, tri_full, s: int, off: int):
    """(h/s + 1, w/s) halo-extended occlusion -> (H, W) by
    triangle-ID-aware bilinear.

    `low`/`tri_lo` carry ONE extra bottom row (the below-halo: the next
    SPMD shard's first sample row, or a clamp copy on a single device /
    the global bottom — ops/pbr._halo_rows), so the i0+1 corner is always
    a real array row and the sharded result equals the single-device one.
    The four bilinear corners come from TWO small axis gathers (W column
    indices on the low-res grid, then H row indices — ~3k indices total,
    nothing like a per-pixel gather); corner weights are bilinear x
    same-triangle-ID, so shadow values never bleed across surfaces; when
    no corner shares the pixel's triangle the plain bilinear stands (the
    standard bilateral-upsample fallback)."""
    big_h, big_w = tri_full.shape
    h_lo, w_lo = low.shape[0] - 1, low.shape[1]
    fy = (jnp.arange(big_h, dtype=jnp.float32) - off) / s
    i0 = jnp.clip(jnp.floor(fy), 0, h_lo - 1).astype(jnp.int32)
    i1 = i0 + 1  # the halo row when i0 is the last real row
    wy = jnp.clip(fy - i0.astype(jnp.float32), 0.0, 1.0)[:, None]
    fx = (jnp.arange(big_w, dtype=jnp.float32) - off) / s
    j0 = jnp.clip(jnp.floor(fx), 0, w_lo - 1).astype(jnp.int32)
    j1 = jnp.minimum(j0 + 1, w_lo - 1)
    wx = jnp.clip(fx - j0.astype(jnp.float32), 0.0, 1.0)[None, :]

    def up(a, iy, jx):
        return jnp.take(jnp.take(a, jx, axis=1), iy, axis=0)

    num = jnp.zeros(tri_full.shape, jnp.float32)
    den = jnp.zeros(tri_full.shape, jnp.float32)
    plain = jnp.zeros(tri_full.shape, jnp.float32)
    for iy, wyc in ((i0, 1.0 - wy), (i1, wy)):
        for jx, wxc in ((j0, 1.0 - wx), (j1, wx)):
            c = up(low, iy, jx)
            t = up(tri_lo, iy, jx)
            wb = wyc * wxc
            wgt = wb * (t == tri_full).astype(jnp.float32)
            num = num + wgt * c
            den = den + wgt
            plain = plain + wb * c  # bilinear weights sum to 1
    return jnp.where(den > 0, num / jnp.maximum(den, 1e-9), plain)


def directional_inputs(scene, m, hcf, live, model, lod, caster_capacity,
                       depth_eps, want=True):
    """occlusion_grid's arguments for one DIRECTIONAL light with view-proj
    `m`: casters culled against and expanded into the light's clip space,
    and receivers hcf (4, H, W) (homogeneous world positions) projected to
    light NDC (x, y, biased depth; +inf where not `live`)."""
    from renderer_jax.ops.geometry import coarse_cull, expand_clip_only

    lclip = jnp.einsum("ij,jhw->ihw", m, hcf, precision="highest")
    lw = jnp.where(jnp.abs(lclip[3]) > 1e-9, lclip[3], 1e-9)
    lx = lclip[0] / lw
    ly = lclip[1] / lw
    ld = jnp.where(live, lclip[2] / lw - depth_eps, jnp.inf)
    clip_mats = jnp.einsum("ij,njk->nik", m, model, precision="highest")
    visible = coarse_cull(scene, model, m) & want
    cclip, cvalid, _ = expand_clip_only(
        scene, visible, lod, clip_mats, caster_capacity
    )
    return cclip, cvalid, lx, ly, ld


def rt_shadow_grid(
    scene,
    world: jnp.ndarray,    # (3, H, W) receiver world positions
    normal: jnp.ndarray,   # (3, H, W) geometric normals (self-shadow offset)
    covered: jnp.ndarray,  # (H, W) bool — pixels that hold geometry
    light_mats: jnp.ndarray,  # (L, 4, 4) from directional_light_matrices
    lod: jnp.ndarray,      # (N,) per-instance LOD
    model: jnp.ndarray,    # (N, 4, 4)
    scene_radius,          # () f32 — bias scale
    caster_capacity: int,
    n_slots: int,
    depth_eps: float = 1.5e-3,
    # production rt tier: trace occlusion on a 1/s
    # subsampled receiver grid (tiles drop ~s^2-fold) and bilateral-upsample
    # per slot with triangle-ID weights; `tri` = (H, W) triangle ids
    # (required when rt_scale > 1). rt_scale=1 traces every pixel (exact).
    # halo_axis: SPMD row-shard mesh axis (the upsample's bottom corner row
    # crosses the shard edge; exchanged like the checkerboard halo).
    tri: jnp.ndarray = None,
    rt_scale: int = 1,
    halo_axis: str = None,
) -> jnp.ndarray:
    """(n_slots, H, W) per-SLOT occlusion planes (slots without a shadow
    light return 1.0 everywhere). Slot-major so the per-slot caster
    expansion + traversal scale with the configured shadow capacity, not
    the light-table size (shading maps lights to slots via
    lights.shadow_slot). Per-light caster expansion includes off-camera
    geometry.

    DIRECTIONAL slots run one ortho traversal. POINT slots run the SAME
    kernel per cube face (fov-90 perspective, the reference ray-query's
    any-light capability, acceleration_strucures.rs:400-569 +
    gltf_mesh.frag:136-160): casters are expanded ONCE into light-centered
    world space, each face applies its rotation+projection to the expanded
    stream (tiny per-face matmuls), and every screen pixel traces only in
    its major-axis face — tiles whose pixels face elsewhere have empty
    receiver bboxes, so the six traversals together touch about one
    screen's worth of tiles."""
    from renderer_jax.ops.geometry import expand_clip_only, mats44
    from renderer_jax.ops.shadow import (
        CUBE_FACE_DIRS,
        CUBE_FACE_UPS,
        lod_by_distance,
    )

    if rt_scale > 1:
        assert tri is not None, "rt_scale > 1 needs the triangle-id plane"
        from renderer_jax.ops.pbr import _halo_rows

        s, off = rt_scale, rt_scale // 2
        occ_lo = rt_shadow_grid(
            scene, world[:, off::s, off::s], normal[:, off::s, off::s],
            covered[off::s, off::s], light_mats, lod, model, scene_radius,
            caster_capacity, n_slots,
            depth_eps=depth_eps,
        )
        tri_lo = tri[off::s, off::s]
        # halo-extend with the below row (next shard's first sample row;
        # clamp copy on a single device / at the global bottom)
        occ_ext = jnp.concatenate(
            [occ_lo, _halo_rows(occ_lo, halo_axis)[1]], axis=-2
        )
        tri_ext = jnp.concatenate(
            [tri_lo, _halo_rows(tri_lo, halo_axis)[1]], axis=-2
        )
        return jnp.stack(
            [
                _bilateral_upsample(occ_ext[k], tri_ext, tri, s, off)
                for k in range(n_slots)
            ],
            axis=0,
        )

    model = mats44(model)
    from renderer_jax.mathx.camera import look_at, perspective

    lights = scene.lights
    # world-space normal offset proportional to scene scale (the normal-
    # offset-shadows trick; replaces per-ray origin epsilon)
    offset_world = world + normal * (scene_radius * 2e-3)
    hcf = jnp.concatenate(
        [offset_world, jnp.ones((1,) + world.shape[1:], jnp.float32)], axis=0
    )

    planes = []
    for slot in range(n_slots):
        match = (lights.shadow_slot == slot) & lights.alive
        li = jnp.argmax(match)
        want = jnp.any(match)
        is_point = want & ~lights.directional[li]
        lpos = lights.position[li]

        def directional(_):
            return occlusion_grid(*directional_inputs(
                scene, light_mats[li], hcf, covered & want, model, lod,
                caster_capacity, depth_eps, want,
            ))

        def point(_):
            # one expansion in light-centered world space (w stays 1)
            trans = jnp.eye(4, dtype=jnp.float32).at[:3, 3].set(-lpos)
            cm = jnp.einsum("ij,njk->nik", trans, model, precision="highest")
            visible = scene.instances.alive & want
            lod_l = lod_by_distance(scene, model, lpos)
            cworld, cvalid, _ = expand_clip_only(
                scene, visible, lod_l, cm, caster_capacity
            )
            # receiver cube face by major axis of light->receiver
            d_l = offset_world - lpos[:, None, None]
            ax, ay, az = jnp.abs(d_l[0]), jnp.abs(d_l[1]), jnp.abs(d_l[2])
            face = jnp.where(
                (ax >= ay) & (ax >= az),
                jnp.where(d_l[0] >= 0, 0, 1),
                jnp.where(
                    ay >= az,
                    jnp.where(d_l[1] >= 0, 2, 3),
                    jnp.where(d_l[2] >= 0, 4, 5),
                ),
            )
            near = scene_radius * 1e-2 + 1e-6
            far = scene_radius * 4.0 + 1e-3
            proj = perspective(jnp.pi / 2, 1.0, near, far)
            zero = jnp.zeros((3,), jnp.float32)
            occ = jnp.ones(world.shape[1:], jnp.float32)
            hrel = jnp.concatenate(
                [d_l, jnp.ones((1,) + world.shape[1:], jnp.float32)], axis=0
            )
            for f in range(6):
                mf = proj @ look_at(
                    zero, jnp.asarray(CUBE_FACE_DIRS[f]), jnp.asarray(CUBE_FACE_UPS[f])
                )
                lclip = jnp.einsum("ij,jhw->ihw", mf, hrel, precision="highest")
                lw = jnp.where(jnp.abs(lclip[3]) > 1e-9, lclip[3], 1e-9)
                lx = lclip[0] / lw
                ly = lclip[1] / lw
                ld = lclip[2] / lw - depth_eps
                sel = covered & want & (face == f)
                ld = jnp.where(sel, ld, jnp.inf)
                cclip = jnp.einsum(
                    "ij,tkj->tki", mf, cworld, precision="highest"
                )
                occ_f = occlusion_grid(cclip, cvalid, lx, ly, ld)
                occ = jnp.where(sel, occ_f, occ)
            return occ

        occ = jax.lax.cond(is_point, point, directional, operand=None)
        planes.append(jnp.where(want, occ, 1.0))
    return jnp.stack(planes, axis=0)
