"""Geometry stage: instance transforms, draw-stream expansion, per-triangle
culling — the array-program equivalent of the reference's GPU-driven cull
pipeline (src/renderer/systems/cull_pipeline.rs +
src/shaders/generate_work.comp).

Where the reference's compute shader appends visible triangles to an indirect
draw stream with subgroup ballots and atomics, here a fixed-capacity
"triangle soup" is expanded from (instance, mesh LOD range) pairs with a
searchsorted gather — the static-shape version of vkCmdDrawIndexedIndirectCount
— and visibility becomes a mask that downstream stages honor (and that a
compaction stage can densify; see ops/cull.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera, camera_matrices
from renderer_jax.ops.raster_spec import FRONT_DET_SIGN
from renderer_jax.scene.types import Scene


class TriangleSoup(NamedTuple):
    """Fixed-capacity post-transform triangle stream (the raster input).

    clip:     (T, 3, 4) clip-space positions
    normal:   (T, 3, 3) world-space normals
    uv:       (T, 3, 2)
    tangent:  (T, 3, 4) world-space tangents (xyz) + handedness (w)
    instance: (T,)      owning instance id (material lookup)
    valid:    (T,)      bool — slot holds a live, non-culled triangle
    count:    ()        i32 — live slots before masking (expansion total)

    World positions are deliberately NOT stored: shading unprojects them from
    the depth buffer (inverse viewproj), and shadow rasterization composes
    light_mat @ viewproj^-1 to act on clip directly — visibility-buffer
    style, saving a third of the stream's HBM traffic.
    """

    clip: jnp.ndarray
    normal: jnp.ndarray
    uv: jnp.ndarray
    tangent: jnp.ndarray
    instance: jnp.ndarray
    valid: jnp.ndarray
    count: jnp.ndarray
    # (T,) i32 library-global triangle index (for draw-list freezing /
    # attribute re-fetch)
    tri_idx: jnp.ndarray
    # (T,) f32 per-triangle base texture LOD: 0.5*log2(uv texel area /
    # screen pixel area) at the atlas's base resolution. A per-triangle
    # constant is the deferred-shading stand-in for screen-space derivatives.
    tex_lod: jnp.ndarray


class DrawList(NamedTuple):
    """The persistent, camera-independent culling result: which (instance,
    triangle) pairs draw this frame. This is what freeze_culling freezes —
    matching the reference, whose bypass pass copies the culled index/indirect
    buffers while vertices are still re-transformed by the live camera
    (cull_pipeline.rs:331-421).

    owner:   (T,) i32 instance id
    tri_idx: (T,) i32 library-global triangle index
    valid:   (T,) bool
    count:   () i32
    """

    owner: jnp.ndarray
    tri_idx: jnp.ndarray
    valid: jnp.ndarray
    count: jnp.ndarray

    @staticmethod
    def empty(capacity: int) -> "DrawList":
        return DrawList(
            owner=jnp.zeros((capacity,), jnp.int32),
            tri_idx=jnp.zeros((capacity,), jnp.int32),
            valid=jnp.zeros((capacity,), bool),
            count=jnp.zeros((), jnp.int32),
        )


def soup_from_draw_list(
    scene: Scene, dl: DrawList, clip_mats: jnp.ndarray, model: jnp.ndarray
) -> TriangleSoup:
    """Re-expand a (frozen) draw list under the CURRENT camera: gather vertex
    data and transform. The vertex-shader half of the reference's frozen-cull
    path."""
    lib = scene.meshes
    vidx = lib.indices[jnp.where(dl.valid, dl.tri_idx, 0)]
    pos = lib.positions[vidx]
    nrm = lib.normals[vidx]
    uv = lib.uvs[vidx]
    tan = lib.tangents[vidx]
    m_clip = mats44(clip_mats)[dl.owner]
    m_model = mats44(model)[dl.owner]
    ones = jnp.ones(pos.shape[:-1] + (1,), pos.dtype)
    hpos = jnp.concatenate([pos, ones], axis=-1)
    clip = jnp.einsum("tij,tnj->tni", m_clip, hpos, precision="highest")
    wnrm = jnp.einsum("tij,tnj->tni", m_model[:, :3, :3], nrm, precision="highest")
    wtan_xyz = jnp.einsum("tij,tnj->tni", m_model[:, :3, :3], tan[..., :3], precision="highest")
    wtan = jnp.concatenate([wtan_xyz, tan[..., 3:]], axis=-1)
    return TriangleSoup(
        clip=clip,
        normal=wnrm,
        uv=uv,
        tangent=wtan,
        instance=dl.owner,
        valid=dl.valid,
        count=dl.count,
        tex_lod=jnp.zeros(dl.owner.shape, jnp.float32),
        tri_idx=dl.tri_idx,
    )


def instance_matrices(scene: Scene) -> jnp.ndarray:
    """(N, 4, 4) model matrices for the whole instance table (one fused op;
    ref: ecs.rs:52-64 model_matrix_calculation)."""
    inst = scene.instances
    return mathx.compose_model_matrices(inst.translation, inst.rotation, inst.scale)


def coarse_cull(scene: Scene, model: jnp.ndarray, viewproj: jnp.ndarray) -> jnp.ndarray:
    """Instance-level frustum cull on world-space AABBs -> (N,) bool visible.
    Ref: cull_pipeline.rs:99-120 coarse_culling (CPU par_for_each)."""
    inst = scene.instances
    model = mats44(model)
    mn = scene.meshes.mesh_aabb_min[inst.mesh_id]
    mx = scene.meshes.mesh_aabb_max[inst.mesh_id]
    wmin, wmax = mathx.transform_aabb(model, mn, mx)
    center = (wmin + wmax) * 0.5
    extent = (wmax - wmin) * 0.5
    planes = mathx.frustum_planes(viewproj)
    outside = mathx.aabb_outside_frustum(planes, center, extent)
    return inst.alive & ~outside


def select_lod(
    scene: Scene, camera: Camera, model: jnp.ndarray, lod_bias: float = 0.0
) -> jnp.ndarray:
    """Distance-based LOD per instance -> (N,) i32 in [0, MAX_LODS).
    Ref: helpers.rs:3-11 (LOD pick by camera distance)."""
    inst = scene.instances
    model = mats44(model)
    center = (scene.meshes.mesh_aabb_min + scene.meshes.mesh_aabb_max) * 0.5
    c = center[inst.mesh_id]
    world_c = jnp.einsum("nij,nj->ni", model[:, :3, :3], c, precision="highest") + model[:, :3, 3]
    dist = jnp.linalg.norm(world_c - camera.position, axis=-1)
    radius = jnp.linalg.norm(
        (scene.meshes.mesh_aabb_max - scene.meshes.mesh_aabb_min)[inst.mesh_id], axis=-1
    ) * (0.5 * inst.scale)
    # screen-coverage proxy: radius / distance
    ratio = radius / jnp.maximum(dist, 1e-6)
    lod = jnp.floor(jnp.log2(jnp.maximum(0.25 / jnp.maximum(ratio, 1e-6), 1.0)) + lod_bias)
    return jnp.clip(lod, 0, scene.meshes.lod_tri_count.shape[1] - 1).astype(jnp.int32)


def expand_draw_stream(
    scene: Scene,
    visible: jnp.ndarray,
    lod: jnp.ndarray,
    clip_mats: jnp.ndarray,
    model: jnp.ndarray,
    capacity: int,
) -> TriangleSoup:
    """Expand (visible instance, LOD triangle range) pairs into the flat
    fixed-capacity triangle soup.

    The mapping soup-slot -> (instance, local tri) is computed on device with
    a cumsum + searchsorted (log N per slot): the static-shape analogue of the
    indirect draw stream. Slots past the live total are invalid.
    """
    inst = scene.instances
    lib = scene.meshes
    n = inst.mesh_id.shape[0]

    tc = jnp.where(visible, lib.lod_tri_count[inst.mesh_id, lod], 0)  # (N,)
    ends = jnp.cumsum(tc)
    total = ends[-1]
    starts = ends - tc

    slots = jnp.arange(capacity, dtype=jnp.int32)
    owner = jnp.searchsorted(ends, slots, side="right").astype(jnp.int32)
    owner = jnp.minimum(owner, n - 1)
    local = slots - starts[owner]
    valid = slots < total

    tri_base = lib.lod_index_offset[inst.mesh_id[owner], lod[owner]]
    tri_idx = jnp.where(valid, tri_base + local, 0)
    vidx = lib.indices[tri_idx]  # (T, 3) library-global vertex ids

    nrm = lib.normals[vidx]
    uv = lib.uvs[vidx]
    tan = lib.tangents[vidx]

    if lib.tri_rec is not None:
        # column-math clip (bit-identical with build_draw_stream's fast path,
        # so the two-phase-vs-legacy property holds exactly)
        n = scene.instances.mesh_id.shape[0]
        rec = lib.tri_rec[tri_idx]
        mm = mats16(clip_mats)[owner]
        clip = _clip_mat(rec, mm)
    else:
        pos = lib.positions[vidx]  # (T, 3, 3)
        m_clip = mats44(clip_mats)[owner]  # (T, 4, 4)
        ones = jnp.ones(pos.shape[:-1] + (1,), pos.dtype)
        hpos = jnp.concatenate([pos, ones], axis=-1)  # (T, 3, 4)
        clip = jnp.einsum("tij,tnj->tni", m_clip, hpos, precision="highest")
    m_model = mats44(model)[owner]
    # normals/tangents: rotate by the linear part (uniform scale => no inverse
    # transpose needed; renormalized in shading)
    wnrm = jnp.einsum("tij,tnj->tni", m_model[:, :3, :3], nrm, precision="highest")
    wtan_xyz = jnp.einsum("tij,tnj->tni", m_model[:, :3, :3], tan[..., :3], precision="highest")
    wtan = jnp.concatenate([wtan_xyz, tan[..., 3:]], axis=-1)

    return TriangleSoup(
        clip=clip,
        normal=wnrm,
        uv=uv,
        tangent=wtan,
        instance=owner,
        valid=valid,
        count=jnp.minimum(total, capacity).astype(jnp.int32),
        tex_lod=jnp.zeros((capacity,), jnp.float32),  # filled by finalize_tex_lod
        tri_idx=tri_idx,
    )


def finalize_tex_lod(soup: TriangleSoup, width: int, height: int, atlas_size: int) -> TriangleSoup:
    """Per-triangle texture LOD = 0.5*log2(uv area in texels / screen area in
    pixels). Triangles crossing w=0 get LOD 0 (conservative sharp)."""
    clip = soup.clip
    w = clip[..., 3]
    ok = jnp.all(w > 1e-9, axis=-1)
    safe_w = jnp.where(jnp.abs(w) > 1e-9, w, 1e-9)
    px = (clip[..., 0] / safe_w + 1.0) * (0.5 * width)
    py = (1.0 - clip[..., 1] / safe_w) * (0.5 * height)

    def tri_area2(x, y):
        return jnp.abs(
            (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
            - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
        )

    a_px = tri_area2(px, py)
    u = soup.uv[..., 0] * atlas_size
    v = soup.uv[..., 1] * atlas_size
    a_uv = tri_area2(u, v)
    ratio = a_uv / jnp.maximum(a_px, 1e-12)
    lod = 0.5 * jnp.log2(jnp.maximum(ratio, 1e-12))
    lod = jnp.where(ok, jnp.maximum(lod, 0.0), 0.0)
    return soup._replace(tex_lod=lod)


def expand_cull_sort_two_phase(
    scene: Scene,
    visible: jnp.ndarray,
    lod: jnp.ndarray,
    clip_mats: jnp.ndarray,
    model: jnp.ndarray,
    expand_capacity: int,
    out_capacity: int,
    width: int,
    height: int,
    cull_backface: bool = True,
) -> TriangleSoup:
    """Two-phase draw-stream build: phase A expands ONLY positions/clip at
    expand_capacity (needed for culling + Morton keys); phase B gathers the
    remaining attributes for the surviving, sorted prefix at out_capacity.

    Post-cull survivors are typically <50% of the expansion (backfaces +
    off-screen), so attribute gathers/transforms and every downstream buffer
    shrink accordingly. Replaces expand_draw_stream + cull_triangles +
    compact_sort_soup in the Pallas pipeline.
    """
    from renderer_jax.ops.cull import _morton2d

    inst = scene.instances
    lib = scene.meshes
    n = inst.mesh_id.shape[0]

    # --- phase A: slot mapping + clip positions only -----------------------
    tc = jnp.where(visible, lib.lod_tri_count[inst.mesh_id, lod], 0)
    ends = jnp.cumsum(tc)
    total = ends[-1]
    starts = ends - tc
    slots = jnp.arange(expand_capacity, dtype=jnp.int32)
    # slot -> owning instance via scatter + cummax (a searchsorted here costs
    # ~14 rounds of 262k-wide gathers = 40+ ms; two scatters + two scans are
    # pure vector work). Instances with tc > 0 have strictly increasing
    # starts, so scatter-max + forward cummax reconstructs the step function.
    has = tc > 0
    dest = jnp.where(has, starts, expand_capacity)  # drop empty instances
    ids = jnp.arange(n, dtype=jnp.int32)
    mark_owner = jnp.zeros((expand_capacity,), jnp.int32).at[dest].max(
        ids + 1, mode="drop"
    )
    owner = jnp.maximum(jax.lax.cummax(mark_owner) - 1, 0)
    mark_start = jnp.zeros((expand_capacity,), jnp.int32).at[dest].max(
        starts, mode="drop"
    )
    local = slots - jax.lax.cummax(mark_start)
    valid = slots < total
    tri_base = lib.lod_index_offset[inst.mesh_id[owner], lod[owner]]
    tri_idx = jnp.where(valid, tri_base + local, 0)
    vidx = lib.indices[tri_idx]
    pos = lib.positions[vidx]
    m_clip = mats44(clip_mats)[owner]
    hpos = jnp.concatenate([pos, jnp.ones(pos.shape[:-1] + (1,), pos.dtype)], -1)
    clip = jnp.einsum("tij,tnj->tni", m_clip, hpos, precision="highest")

    # --- cull masks (same math as cull_triangles, inline to reuse clip) ----
    u = pixel_homogeneous(clip, 2, 2)
    m = jnp.swapaxes(u, -1, -2)
    det = (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )
    mask = valid & frustum_cull_mask(clip)
    if cull_backface:
        mask = mask & (det * FRONT_DET_SIGN > 0)
    else:
        mask = mask & (det != 0)

    # --- Morton keys + single argsort (invalid -> back) --------------------
    w = clip[..., 3]
    safe_w = jnp.where(jnp.abs(w) > 1e-9, w, 1e-9)
    all_front = jnp.all(w > 1e-9, axis=-1)
    px = clip[..., 0] / safe_w
    py = clip[..., 1] / safe_w
    cx = jnp.clip((jnp.min(px, -1) + jnp.max(px, -1)) * 0.25 + 0.5, 0.0, 1.0)
    cy = jnp.clip((jnp.min(py, -1) + jnp.max(py, -1)) * -0.25 + 0.5, 0.0, 1.0)
    gx = jnp.where(all_front, (cx * 1023).astype(jnp.uint32), 0)
    gy = jnp.where(all_front, (cy * 1023).astype(jnp.uint32), 0)
    key = jnp.where(mask, _morton2d(gx, gy), jnp.uint32(0xFFFFFFFF))
    perm = jnp.argsort(key, stable=True)[:out_capacity]  # survivors first

    count = jnp.minimum(
        jnp.sum(mask.astype(jnp.int32)), out_capacity
    ).astype(jnp.int32)
    out_valid = jnp.arange(out_capacity, dtype=jnp.int32) < count

    # --- phase B: gather attributes for the surviving prefix ---------------
    owner_s = owner[perm]
    tri_idx_s = tri_idx[perm]
    clip_s = clip[perm]
    vidx_s = lib.indices[tri_idx_s]
    nrm = lib.normals[vidx_s]
    uv = lib.uvs[vidx_s]
    tan = lib.tangents[vidx_s]
    m_model = mats44(model)[owner_s]
    wnrm = jnp.einsum("tij,tnj->tni", m_model[:, :3, :3], nrm, precision="highest")
    wtan_xyz = jnp.einsum(
        "tij,tnj->tni", m_model[:, :3, :3], tan[..., :3], precision="highest"
    )
    wtan = jnp.concatenate([wtan_xyz, tan[..., 3:]], axis=-1)

    soup = TriangleSoup(
        clip=clip_s,
        normal=wnrm,
        uv=uv,
        tangent=wtan,
        instance=owner_s,
        valid=out_valid,
        count=count,
        tex_lod=jnp.zeros((out_capacity,), jnp.float32),
        tri_idx=tri_idx_s,
    )
    return finalize_tex_lod(soup, width, height, scene.atlas.level_size[0])


## column-math draw-stream build (tri_rec fast path) -------------------------
# Tiled device layouts pad small trailing dims, so (E, 4, 4) / (E, 3, 4)
# temporaries in an einsum formulation can cost many times their logical
# bytes. The fast path keeps EVERYTHING as flat (E,) columns or (E, k)
# tables: one wide gather from the per-triangle record table
# (scene.meshes.tri_rec) replaces the per-corner vertex gathers, and plain
# FMAs on columns replace the batched tiny matmuls (identical f32 ops).


def _t_cols(x: jnp.ndarray) -> jnp.ndarray:
    """(E, k) -> (k, E) via a TRANSPOSING identity dot_general — the layout
    firewall for gathered tables.

    A dot pins its operands' layouts, so the gather keeps row-major
    writes, and the (k, E) row-major output makes every column read a
    contiguous row (a naked `.T` lets XLA sink the transposed layout into
    the upstream gather, whose writes then go strided). Exact: each output
    element is value * 1.0 plus zeros, f32 with pinned precision. Whether a
    plain transpose is cheaper on the GPU is not measured."""
    k = x.shape[1]
    eye = jnp.eye(k, dtype=jnp.float32)
    return jax.lax.dot_general(
        eye, x, (((1,), (1,)), ((), ())), precision="highest"
    )


def _rows_from_cols(cols: list) -> jnp.ndarray:
    """[(E,) x k] columns -> (E, k) row-major block, via stack-as-rows plus
    a transposing identity dot (the reverse of _t_cols).

    Stacking on axis=0 is k contiguous row writes; the identity dot
    transposes the (k, E) result back."""
    c = jnp.stack(cols, axis=0)  # (k, E), contiguous rows
    k = c.shape[0]
    eye = jnp.eye(k, dtype=jnp.float32)
    return jax.lax.dot_general(
        c, eye, (((0,), (0,)), ((), ())), precision="highest"
    )  # (E, k)


def mats16(m: jnp.ndarray) -> jnp.ndarray:
    """(N, 16) flat row form of per-instance matrices; accepts (N, 4, 4).

    The flat form is the canonical layout of the `prepared` tuple: a
    materialized (N, 4, 4) may be tiled with padding on its trailing dims,
    so every downstream `.reshape(n, 16)` would be a relayout copy."""
    return m if m.ndim == 2 else m.reshape(m.shape[0], 16)


def mats44(m: jnp.ndarray) -> jnp.ndarray:
    """(N, 4, 4) view for matrix-math consumers; accepts flat (N, 16).

    One relayout per frame at most — used only by feature paths that do
    genuine per-instance matrix algebra (occlusion re-cull, per-light
    shadow/rt setup, debug AABBs, the freeze re-transform)."""
    return m if m.ndim == 3 else m.reshape(m.shape[0], 4, 4)


def _clip_cols(rec: jnp.ndarray, mm: jnp.ndarray, rt=None, mt=None) -> list:
    """12 clip columns [c0:x,y,z,w, c1:..., c2:...] from tri records
    (E, 36) and flat per-triangle clip matrices (E, 16): transposing-dot
    firewalls (see _t_cols) + pure column FMAs (identical f32 op order for
    every caller, so phase A and phase B stay bit-identical).

    rt/mt: pre-transposed (36, E)/(16, E) tables when the caller already
    built them (phase B reuses the record table for normals/uvs)."""
    from renderer_jax.scene.types import TR_POS

    if rt is None:
        rt = _t_cols(rec)
    if mt is None:
        mt = _t_cols(mm)
    cols = []
    for c in range(3):
        x = rt[TR_POS + 3 * c]
        y = rt[TR_POS + 3 * c + 1]
        z = rt[TR_POS + 3 * c + 2]
        for j in range(4):
            cols.append(
                x * mt[4 * j] + y * mt[4 * j + 1] + z * mt[4 * j + 2]
                + mt[4 * j + 3]
            )
    return cols


def _clip_mat(rec: jnp.ndarray, mm: jnp.ndarray) -> jnp.ndarray:
    """(E, 3, 4) clip positions — row-major block of _clip_cols for
    consumers that need the per-triangle matrix form (raster setup)."""
    e = rec.shape[0]
    return _rows_from_cols(_clip_cols(rec, mm)).reshape(e, 3, 4)


def _slot_map_starts(counts, capacity: int):
    """Expansion slot map core: slot -> (owner, start-of-owner's-run) via ONE
    packed scatter-max + cummax (owner and start share a u32; owner is
    monotone in start so the packed key is monotone). Returns
    (owner, start, slots, valid, total)."""
    n = counts.shape[0]
    ends = jnp.cumsum(counts)
    total = ends[-1]
    starts = ends - counts
    has = counts > 0
    dest = jnp.where(has, starts, capacity)
    bits_s = max(1, (capacity - 1).bit_length())
    bits_o = max(1, (n - 1).bit_length())
    slots = jnp.arange(capacity, dtype=jnp.int32)
    valid = slots < total
    if bits_s + bits_o <= 32:
        key = (jnp.arange(n, dtype=jnp.uint32) << bits_s) | starts.astype(jnp.uint32)
        mark = jnp.zeros((capacity,), jnp.uint32).at[dest].max(key, mode="drop")
        run = jax.lax.cummax(mark)
        owner = (run >> bits_s).astype(jnp.int32)
        start = (run & jnp.uint32((1 << bits_s) - 1)).astype(jnp.int32)
    else:  # capacity too large to pack: two scans
        ids = jnp.arange(n, dtype=jnp.int32)
        mark_o = jnp.zeros((capacity,), jnp.int32).at[dest].max(ids + 1, mode="drop")
        owner = jnp.maximum(jax.lax.cummax(mark_o) - 1, 0)
        mark_s = jnp.zeros((capacity,), jnp.int32).at[dest].max(starts, mode="drop")
        start = jax.lax.cummax(mark_s)
    return owner, start, slots, valid, total


def _slot_map_counts(counts, base_i, capacity: int):
    """Slot map + per-slot source index base_i[owner] + local. Returns
    (owner, idx, valid, total)."""
    owner, start, slots, valid, total = _slot_map_starts(counts, capacity)
    idx = jnp.where(valid, base_i[owner] + (slots - start), 0)
    return owner, idx, valid, total


def _slot_map(scene, visible, lod, expand_capacity: int):
    """Per-TRIANGLE expansion slot map (see _slot_map_counts)."""
    inst = scene.instances
    lib = scene.meshes
    tc = jnp.where(visible, lib.lod_tri_count[inst.mesh_id, lod], 0)
    base_i = lib.lod_index_offset[inst.mesh_id, lod]
    return _slot_map_counts(tc, base_i, expand_capacity)


def _cluster_slot_map(
    scene, visible, lod, expand_capacity: int, model, camera_pos, vp,
    cull_backface: bool,
):
    """Two-level cluster expansion with cluster-grain culling.

    Level 1 runs the slot map at CLUSTER granularity (1/32 the scan width)
    and culls whole clusters by bounding-sphere-vs-frustum and normal-cone
    backface tests (meshlet-style; the reference's analogue is its per-mesh
    cull dispatch granularity). Level 2 is a fixed-stride expansion of the
    surviving clusters — no per-triangle scan at all. Returns
    (owner, tri_idx, valid) with valid covering exactly the surviving
    clusters' 32-triangle ranges (range padding is degenerate and falls to
    the per-triangle mask)."""
    from renderer_jax.mathx.camera import frustum_planes
    from renderer_jax.scene.types import (
        CL_AXIS, CL_CENTER, CL_COS, CL_COUNT, CL_RADIUS, CL_SIN, CLUSTER,
    )

    inst = scene.instances
    lib = scene.meshes
    n = inst.mesh_id.shape[0]
    assert expand_capacity % CLUSTER == 0
    e_c = expand_capacity // CLUSTER

    tc = jnp.where(visible, lib.lod_tri_count[inst.mesh_id, lod], 0)
    ci = (tc + CLUSTER - 1) // CLUSTER
    base_c = lib.lod_index_offset[inst.mesh_id, lod] // CLUSTER
    # the pre-cull cluster list gets 2x headroom: cluster-level ops are ~1/32
    # the cost of triangle slots, and range padding inflates the REQUEST even
    # though cone/frustum culling shrinks the SURVIVORS back under e_c
    # (truncating before culling once silently dropped ~4% of the bench's
    # visible triangles)
    owner_c, cl_idx, valid_c, _ = _slot_map_counts(ci, base_c, 2 * e_c)

    keep = valid_c
    cdt = lib.cluster_data[cl_idx].T  # (CL_COLS, E_c) — rows are free
    # real-prefix length per cluster: pad slots are masked STRUCTURALLY
    # (their degenerate det is NOT exactly 0 under FMA contraction)
    real_count = cdt[CL_COUNT].astype(jnp.int32)
    if camera_pos is not None:
        mt = mats16(model)[owner_c].T  # (16, E_c)
        sc = inst.scale[owner_c]
        c0, c1, c2 = cdt[CL_CENTER], cdt[CL_CENTER + 1], cdt[CL_CENTER + 2]
        cw = [mt[4 * i] * c0 + mt[4 * i + 1] * c1 + mt[4 * i + 2] * c2 + mt[4 * i + 3]
              for i in range(3)]
        r_w = cdt[CL_RADIUS] * sc
        planes = frustum_planes(vp)
        outside = None
        for p in range(6):
            d = (planes[p, 0] * cw[0] + planes[p, 1] * cw[1]
                 + planes[p, 2] * cw[2] + planes[p, 3])
            o = d < -r_w
            outside = o if outside is None else (outside | o)
            if p == 4:
                d_near = d
        keep &= ~outside
        if cull_backface:
            a0, a1, a2 = cdt[CL_AXIS], cdt[CL_AXIS + 1], cdt[CL_AXIS + 2]
            # axis through the model linear part has length `scale`; the
            # cone test is scale-multiplied through so no normalization:
            #   cos*dot(axis_s,u) + s*sin*|u| + s*r_w < 0  (u = eye - center)
            aw = [mt[4 * i] * a0 + mt[4 * i + 1] * a1 + mt[4 * i + 2] * a2
                  for i in range(3)]
            u = [camera_pos[k] - cw[k] for k in range(3)]
            ulen = jnp.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
            dot_au = aw[0] * u[0] + aw[1] * u[1] + aw[2] * u[2]
            backfacing = (
                cdt[CL_COS] * dot_au + sc * cdt[CL_SIN] * ulen + sc * r_w < 0
            )
            # clusters near/behind the eye plane can hold w-crossing
            # triangles whose clip-space facing differs from the world test;
            # only cone-cull spheres strictly inside the near halfspace
            safe = d_near > r_w
            keep &= ~(backfacing & safe)

    # compact surviving clusters, then a second slot map expands them with
    # their EXACT real triangle counts — no padding inflation of the
    # triangle budget (whole-cluster striding once truncated ~4% of the
    # bench's visible triangles when padded demand exceeded capacity)
    n_cc = 2 * e_c
    posn = jnp.cumsum(keep.astype(jnp.int32)) - 1
    dest = jnp.where(keep, posn, n_cc)
    counts_cc = jnp.zeros((n_cc,), jnp.int32).at[dest].set(real_count, mode="drop")
    bits_b = max(1, (lib.indices.shape[0] - 1).bit_length())
    bits_o = max(1, (n - 1).bit_length())
    if bits_b + bits_o <= 31:
        # pack (owner << bits_b) | tri_base as the slot-map "base": adding
        # local (< CLUSTER <= tri range granularity) never carries into the
        # owner bits, so one slot map yields both ids with zero extra gathers
        packed = (owner_c.astype(jnp.int32) << bits_b) | (cl_idx * CLUSTER)
        base_cc = jnp.zeros((n_cc,), jnp.int32).at[dest].set(packed, mode="drop")
        _, idx, valid, _ = _slot_map_counts(counts_cc, base_cc, expand_capacity)
        owner = idx >> bits_b
        tri_idx = jnp.where(valid, idx & ((1 << bits_b) - 1), 0)
    else:
        owner_cc = jnp.zeros((n_cc,), jnp.int32).at[dest].set(owner_c, mode="drop")
        base_cc = jnp.zeros((n_cc,), jnp.int32).at[dest].set(
            cl_idx * CLUSTER, mode="drop"
        )
        c_slot, idx, valid, _ = _slot_map_counts(counts_cc, base_cc, expand_capacity)
        owner = owner_cc[c_slot]
        tri_idx = jnp.where(valid, idx, 0)
    owner = jnp.clip(owner, 0, n - 1)
    return owner, tri_idx, valid


def cluster_budget_overflow(
    scene: Scene, visible: jnp.ndarray, lod: jnp.ndarray, expand_capacity: int
) -> jnp.ndarray:
    """() i32 — clusters beyond _cluster_slot_map's pre-cull budget this
    frame (the 2x-headroom list; overflow silently drops visible geometry,
    so the HUD surfaces it like the raster bin-overflow counter). Scenes
    dominated by nearly-empty clusters can exhaust the cluster budget long
    before the triangle budget."""
    from renderer_jax.scene.types import CLUSTER

    inst = scene.instances
    lib = scene.meshes
    tc = jnp.where(visible, lib.lod_tri_count[inst.mesh_id, lod], 0)
    ci = (tc + CLUSTER - 1) // CLUSTER
    budget = 2 * (expand_capacity // CLUSTER)
    return jnp.maximum(jnp.sum(ci) - budget, 0)


def expansion_demand(scene: Scene, visible: jnp.ndarray, lod: jnp.ndarray):
    """() i32 — total triangles the visible set WANTS to expand this frame.

    The truncation-free signal for capacity budgeting (runtime/autocap.py):
    expand_draw_stream clamps silently at its capacity and the post-cull
    draw-list count only reports survivors of whatever made it through, so
    neither says how much was dropped. This is the camera-path analogue of
    shadow_caster_truncation's per-slot demand (ops/shadow.py)."""
    tc = jnp.where(
        visible, scene.meshes.lod_tri_count[scene.instances.mesh_id, lod], 0
    )
    return jnp.sum(tc)


def prepare_frame_columns(scene: Scene, camera: Camera):
    """The whole prepare stage (model matrices, clip matrices, coarse cull,
    LOD select, scene bounds) in flat column math.

    The einsum formulation materializes (N,4,4)/(N,3) intermediates with
    tiny trailing dims; every quantity here is an (N,) column, and the
    matrices are stacked ONCE at the end in FLAT (N, 16) form (mats16 — the cull path consumes flat rows; matrix-math consumers
    take a mats44 view). Returns the pipeline's `prepared` tuple:
    (model16, vp, clip16, visible, lod, scene_min, scene_max, vp_inv,
    camera_position)."""
    from renderer_jax.mathx.camera import camera_matrices, frustum_planes

    inst = scene.instances
    lib = scene.meshes
    tt = inst.translation.T  # (3, N)
    qt = inst.rotation.T     # (4, N)
    s = inst.scale
    w, x, y, z = qt[0], qt[1], qt[2], qt[3]
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    m = [[r[i][j] * s for j in range(3)] + [tt[i]] for i in range(3)]

    _, _, vp = camera_matrices(camera)
    clip_cols = []
    for i in range(4):
        for j in range(4):
            c = vp[i, 0] * m[0][j] + vp[i, 1] * m[1][j] + vp[i, 2] * m[2][j]
            if j == 3:
                c = c + vp[i, 3]
            clip_cols.append(c)

    # world AABBs (center/extent |linear| trick), all columns
    mn_t = lib.mesh_aabb_min[inst.mesh_id].T  # (3, N)
    mx_t = lib.mesh_aabb_max[inst.mesh_id].T
    c_loc = [(mn_t[k] + mx_t[k]) * 0.5 for k in range(3)]
    e_loc = [(mx_t[k] - mn_t[k]) * 0.5 for k in range(3)]
    cw = [
        m[i][0] * c_loc[0] + m[i][1] * c_loc[1] + m[i][2] * c_loc[2] + m[i][3]
        for i in range(3)
    ]
    ew = [
        jnp.abs(m[i][0]) * e_loc[0] + jnp.abs(m[i][1]) * e_loc[1]
        + jnp.abs(m[i][2]) * e_loc[2]
        for i in range(3)
    ]

    planes = frustum_planes(vp)  # (6, 4)
    outside = None
    for p in range(6):
        d = planes[p, 0] * cw[0] + planes[p, 1] * cw[1] + planes[p, 2] * cw[2] + planes[p, 3]
        rr = (
            jnp.abs(planes[p, 0]) * ew[0]
            + jnp.abs(planes[p, 1]) * ew[1]
            + jnp.abs(planes[p, 2]) * ew[2]
        )
        out_p = d + rr < 0.0
        outside = out_p if outside is None else (outside | out_p)
    visible = inst.alive & ~outside

    # LOD select (screen-coverage proxy; same formula as select_lod)
    cam_p = camera.position
    dx = cw[0] - cam_p[0]
    dy = cw[1] - cam_p[1]
    dz = cw[2] - cam_p[2]
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    radius = jnp.sqrt(
        (mx_t[0] - mn_t[0]) ** 2 + (mx_t[1] - mn_t[1]) ** 2 + (mx_t[2] - mn_t[2]) ** 2
    ) * (0.5 * s)
    ratio = radius / jnp.maximum(dist, 1e-6)
    lod = jnp.floor(jnp.log2(jnp.maximum(0.25 / jnp.maximum(ratio, 1e-6), 1.0)))
    lod = jnp.clip(lod, 0, lib.lod_tri_count.shape[1] - 1).astype(jnp.int32)

    # scene bounds over alive instances (shadow camera fit)
    big = jnp.float32(1e9)
    alive = inst.alive
    scene_min = jnp.stack(
        [jnp.min(jnp.where(alive, cw[k] - ew[k], big)) for k in range(3)]
    )
    scene_max = jnp.stack(
        [jnp.max(jnp.where(alive, cw[k] + ew[k], -big)) for k in range(3)]
    )

    # materialize FLAT (N, 16) forms (see mats16): the cull path consumes
    # flat rows directly; (N, 4, 4) views are made per-consumer (mats44)
    n = s.shape[0]
    bottom = [jnp.zeros((n,), jnp.float32)] * 3 + [jnp.ones((n,), jnp.float32)]
    model = jnp.stack(m[0] + m[1] + m[2] + bottom, axis=-1)  # (N, 16)
    clip_mats = jnp.stack(clip_cols, axis=-1)  # (N, 16)
    vp_inv = jnp.linalg.inv(vp)
    return (
        model, vp, clip_mats, visible, lod, scene_min, scene_max, vp_inv,
        camera.position,
    )


def expand_clip_only(
    scene: Scene,
    visible: jnp.ndarray,
    lod: jnp.ndarray,
    clip_mats: jnp.ndarray,
    capacity: int,
):
    """Positions-only draw-stream expansion -> (clip (T,3,4), valid, count).

    The light-frustum caster path (per-light shadow rendering) needs only
    transformed positions; skipping attributes/sort keeps per-light cost at
    one wide gather + column math."""
    lib = scene.meshes
    inst = scene.instances
    n = inst.mesh_id.shape[0]
    owner, tri_idx, valid, total = _slot_map(scene, visible, lod, capacity)
    if lib.tri_rec is not None:
        rec = lib.tri_rec[tri_idx]
        mm = mats16(clip_mats)[owner]
        clip = _clip_mat(rec, mm)
    else:
        vidx = lib.indices[tri_idx]
        pos = lib.positions[vidx]
        m_clip = mats44(clip_mats)[owner]
        hpos = jnp.concatenate([pos, jnp.ones(pos.shape[:-1] + (1,), pos.dtype)], -1)
        clip = jnp.einsum("tij,tnj->tni", m_clip, hpos, precision="highest")
    count = jnp.minimum(total, capacity).astype(jnp.int32)
    return clip, valid, count


def build_draw_stream(
    scene: Scene,
    visible: jnp.ndarray,
    lod: jnp.ndarray,
    clip_mats: jnp.ndarray,
    model: jnp.ndarray,
    expand_capacity: int,
    out_capacity: int,
    width: int,
    height: int,
    cull_backface: bool = True,
    want_soup_attrs: bool = False,
    camera_pos=None,  # (3,) eye — enables cluster-grain culling when the
    vp=None,          # (4,4) viewproj — scene carries cluster_data
):
    """Fused expansion + per-triangle cull + Morton sort + shade-record
    build. Returns (TriangleSoup, (T, SR_COLS) shade records).

    Fast path requires scene.meshes.tri_rec (invalidated by the pose pass);
    otherwise falls back to the gather-per-corner implementation. With
    want_soup_attrs=False the soup's normal/uv/tangent fields are zeros
    (dead-code eliminated inside the frame jit) — PBR shading reads the
    packed records instead."""
    from renderer_jax.scene.types import TR_NRM, TR_TAN, TR_UV

    lib = scene.meshes
    if lib.tri_rec is None:
        soup = expand_cull_sort_two_phase(
            scene, visible, lod, clip_mats, model,
            expand_capacity, out_capacity, width, height,
            cull_backface=cull_backface,
        )
        # render_size packs SR_EDGE so shading can derive barycentrics from
        # records on this path too
        return soup, build_shade_records(soup, scene, render_size=(width, height))

    from renderer_jax.ops.cull import _morton2d

    inst = scene.instances
    n = inst.mesh_id.shape[0]
    use_clusters = (
        lib.cluster_data is not None
        and expand_capacity % 32 == 0
        and camera_pos is not None
    )
    if use_clusters:
        owner, tri_idx, valid = _cluster_slot_map(
            scene, visible, lod, expand_capacity, model, camera_pos, vp,
            cull_backface,
        )
        # --- phase A: positions only, column math ---------------------------
        rec = lib.tri_rec[tri_idx]  # (E, 36) — THE wide gather
        mm = mats16(clip_mats)[owner]  # (E, 16)
        cc = _clip_cols(rec, mm)
    else:
        tc = jnp.where(visible, lib.lod_tri_count[inst.mesh_id, lod], 0)
        base_i = lib.lod_index_offset[inst.mesh_id, lod]
        owner, start, slots, valid, _ = _slot_map_starts(tc, expand_capacity)
        if lib.tri_rec.shape[0] < (1 << 24):
            # fold base_i into the wide per-owner gather row: gathers are
            # index-rate bound, so one (E, 17) row gather costs what the
            # (E, 16) clip-matrix gather did, and the separate 1-wide
            # base_i[owner] gather
            # disappears. f32 carries base_i exactly below 2^24.
            g = jnp.concatenate(
                [mats16(clip_mats), base_i.astype(jnp.float32)[:, None]],
                axis=1,
            )  # (N, 17)
            gt = _t_cols(g[owner])  # (17, E): clip-matrix columns + base
            tri_idx = jnp.where(
                valid, gt[16].astype(jnp.int32) + (slots - start), 0
            )
            rec = lib.tri_rec[tri_idx]  # (E, 36) — THE wide gather
            cc = _clip_cols(rec, None, mt=gt[:16])
        else:
            tri_idx = jnp.where(valid, base_i[owner] + (slots - start), 0)
            rec = lib.tri_rec[tri_idx]
            mm = mats16(clip_mats)[owner]
            cc = _clip_cols(rec, mm)
    x = [cc[0], cc[4], cc[8]]
    y = [cc[1], cc[5], cc[9]]
    z = [cc[2], cc[6], cc[10]]
    w = [cc[3], cc[7], cc[11]]

    # frustum reject (same comparisons as frustum_cull_mask, column form)
    out = (x[0] < -w[0]) & (x[1] < -w[1]) & (x[2] < -w[2])
    out |= (x[0] > w[0]) & (x[1] > w[1]) & (x[2] > w[2])
    out |= (y[0] < -w[0]) & (y[1] < -w[1]) & (y[2] < -w[2])
    out |= (y[0] > w[0]) & (y[1] > w[1]) & (y[2] > w[2])
    out |= (z[0] < 0) & (z[1] < 0) & (z[2] < 0)
    out |= (z[0] > w[0]) & (z[1] > w[1]) & (z[2] > w[2])
    # backface: same determinant as triangle_setup at width=height=2
    u0 = [x[c] + w[c] for c in range(3)]
    u1 = [w[c] - y[c] for c in range(3)]
    u2 = w
    det = (
        u0[0] * (u1[1] * u2[2] - u1[2] * u2[1])
        - u0[1] * (u1[0] * u2[2] - u1[2] * u2[0])
        + u0[2] * (u1[0] * u2[1] - u1[1] * u2[0])
    )
    mask = valid & ~out
    if cull_backface:
        mask &= det * FRONT_DET_SIGN > 0
    else:
        mask &= det != 0

    # --- Morton keys + argsort (invalid -> back) ----------------------------
    safe = [jnp.where(jnp.abs(wc) > 1e-9, wc, 1e-9) for wc in w]
    all_front = (w[0] > 1e-9) & (w[1] > 1e-9) & (w[2] > 1e-9)
    px = [x[c] / safe[c] for c in range(3)]
    py = [y[c] / safe[c] for c in range(3)]
    cx = jnp.clip(
        (jnp.minimum(jnp.minimum(px[0], px[1]), px[2])
         + jnp.maximum(jnp.maximum(px[0], px[1]), px[2])) * 0.25 + 0.5,
        0.0, 1.0,
    )
    cy = jnp.clip(
        (jnp.minimum(jnp.minimum(py[0], py[1]), py[2])
         + jnp.maximum(jnp.maximum(py[0], py[1]), py[2])) * -0.25 + 0.5,
        0.0, 1.0,
    )
    gx = jnp.where(all_front, (cx * 1023).astype(jnp.uint32), 0)
    gy = jnp.where(all_front, (cy * 1023).astype(jnp.uint32), 0)
    key = jnp.where(mask, _morton2d(gx, gy), jnp.uint32(0xFFFFFFFF))
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), out_capacity).astype(jnp.int32)
    out_valid = jnp.arange(out_capacity, dtype=jnp.int32) < count

    # --- phase B: records for the surviving prefix --------------------------
    # payload sort: carrying (owner, tri_idx) through ONE stable sort avoids
    # the two post-argsort permutation gathers (sorts are cheap here,
    # gathers are index-rate bound). Same order as
    # argsort(stable) — ties break by index either way. When the id bits fit
    # one word (owner < 2^14, library tri_idx < 2^16 at the bench), the two
    # payloads pack into ONE i32: every merge pass of the 262k sort moves a
    # third less payload, and the unpack shifts are free vector ops.
    bits_t2 = max(1, (lib.tri_rec.shape[0] - 1).bit_length())
    bits_o2 = max(1, (n - 1).bit_length())
    if bits_t2 + bits_o2 <= 31:
        packed_ot = (owner << bits_t2) | tri_idx
        _, packed_p = jax.lax.sort((key, packed_ot), num_keys=1, is_stable=True)
        packed_s = packed_p[:out_capacity]
        owner_s = packed_s >> bits_t2
        tri_s = packed_s & ((1 << bits_t2) - 1)
    else:
        _, owner_p, tri_p = jax.lax.sort(
            (key, owner, tri_idx), num_keys=1, is_stable=True
        )
        owner_s = owner_p[:out_capacity]
        tri_s = tri_p[:out_capacity]
    rec_s = lib.tri_rec[tri_s]  # (T, 36)
    # recompute survivor clip from the same inputs with the same op order
    # (bit-identical with phase A). ONE transposing dot per gathered table
    # (_t_cols) firewalls the layouts; everything downstream is column FMAs
    # on contiguous rows (a batched-3D-dot formulation pays relayout
    # reshapes + copies + small matmuls).
    t_out = out_capacity
    # ONE combined per-owner gather row (clip matrix | model matrix |
    # material record): gathers are index-rate bound, so one (T, 43) row
    # fetch costs what one (T, 16) did, replacing three separate
    # owner_s-indexed gathers (+ the material table's own transposing dot —
    # its columns come out of the shared one below)
    mats = scene.materials
    mat_rec = jnp.concatenate(
        [
            mats.base_color_factor,
            mats.metallic[:, None],
            mats.roughness[:, None],
            mats.emissive,
            mats.base_color_tex[:, None].astype(jnp.float32),
            mats.normal_tex[:, None].astype(jnp.float32),
        ],
        axis=1,
    )  # (K, 11) — matches SR_BASE..SR_NM_LAYER order
    # build the (N, 43) table via column rows + ONE transposing dot: a
    # minor-axis concat of the three pieces writes 33 strided (N, k)
    # sub-copies; dense (43, N) row writes + one transposing dot do not
    g2t = jnp.concatenate(
        [
            _t_cols(mats16(clip_mats)),
            _t_cols(mats16(model)),
            _t_cols(mat_rec[inst.material_id]),  # (11, N)
        ],
        axis=0,
    )  # (43, N) contiguous rows
    g2 = jax.lax.dot_general(
        g2t, jnp.eye(g2t.shape[0], dtype=jnp.float32),
        (((0,), (0,)), ((), ())), precision="highest",
    )  # (N, 43) row-major
    gt2 = _t_cols(g2[owner_s])  # (43, T)
    rts = _t_cols(rec_s)  # (36, T): positions, normals, uvs, tangents
    mts_clip = gt2[:16]  # (16, T)
    ccs = _clip_cols(rec_s, None, rt=rts, mt=mts_clip)
    cm_s = _rows_from_cols(ccs).reshape(t_out, 3, 4)  # soup clip
    # normal/tangent rotation by the model linear part, column form:
    # w[c][j] = sum_k v[3c+k] * lin[j][k], lin[j][k] = model_row[4j+k]
    mts = gt2[16:32]  # (16, T)

    def rot_cols(base, stride):
        return [
            rts[base + stride * c] * mts[4 * j]
            + rts[base + stride * c + 1] * mts[4 * j + 1]
            + rts[base + stride * c + 2] * mts[4 * j + 2]
            for c in range(3)
            for j in range(3)
        ]

    wn_cols = rot_cols(TR_NRM, 3)  # [c0.xyz, c1.xyz, c2.xyz]
    wt_cols = rot_cols(TR_TAN, 4)
    uv_cols = [rts[TR_UV + k] for k in range(6)]
    tan_cols = [
        wt_cols[3 * c + j] if j < 3 else rts[TR_TAN + 4 * c + 3]
        for c in range(3)
        for j in range(4)
    ]  # [xyz w] x3

    # per-triangle texture LOD (same formula as finalize_tex_lod)
    sw = [jnp.where(jnp.abs(ccs[4 * c + 3]) > 1e-9, ccs[4 * c + 3], 1e-9)
          for c in range(3)]
    ok_w = (ccs[3] > 1e-9) & (ccs[7] > 1e-9) & (ccs[11] > 1e-9)
    spx = [(ccs[4 * c] / sw[c] + 1.0) * (0.5 * width) for c in range(3)]
    spy = [(1.0 - ccs[4 * c + 1] / sw[c]) * (0.5 * height) for c in range(3)]
    a_px = jnp.abs(
        (spx[1] - spx[0]) * (spy[2] - spy[0]) - (spx[2] - spx[0]) * (spy[1] - spy[0])
    )
    atlas_size = scene.atlas.level_size[0]
    su = [uv_cols[2 * c] * atlas_size for c in range(3)]
    sv = [uv_cols[2 * c + 1] * atlas_size for c in range(3)]
    a_uv = jnp.abs((su[1] - su[0]) * (sv[2] - sv[0]) - (su[2] - su[0]) * (sv[1] - sv[0]))
    tex_lod = 0.5 * jnp.log2(jnp.maximum(a_uv / jnp.maximum(a_px, 1e-12), 1e-12))
    tex_lod = jnp.where(ok_w, jnp.maximum(tex_lod, 0.0), 0.0)

    # material columns ride the combined gather (gt2 rows 32..42)

    # edge coefficients (SR_EDGE): adj(M) rows = cross products of the other
    # two pixel-homogeneous columns; shading divides λ_i by Σλ so any common
    # scale (including facing sign) cancels
    hw, hh = 0.5 * width, 0.5 * height
    uvec = [
        (
            (ccs[4 * c] + ccs[4 * c + 3]) * hw,
            (ccs[4 * c + 3] - ccs[4 * c + 1]) * hh,
            ccs[4 * c + 3],
        )
        for c in range(3)
    ]

    def cross_cols(a, b):
        return [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]

    edge_cols = (
        cross_cols(uvec[1], uvec[2])
        + cross_cols(uvec[2], uvec[0])
        + cross_cols(uvec[0], uvec[1])
    )

    # the WHOLE record as one column stack + ONE transposing dot (instead
    # of per-block _rows_from_cols dots plus two minor-axis concats and a
    # zero-pad write).
    mat_t = gt2[32:43]  # (11, T) material columns, free rows
    all_cols = (
        wn_cols  # SR_NORMAL: 9
        + uv_cols  # SR_UV: 6
        + tan_cols  # SR_TANGENT: 12
        + [tex_lod, owner_s.astype(jnp.float32)]  # SR_TEXLOD, SR_INSTANCE
        + [mat_t[i] for i in range(11)]  # SR_BASE .. SR_NM_LAYER
        + edge_cols  # SR_EDGE: 9
    )
    stacked = jnp.concatenate(
        [
            jnp.stack(all_cols, axis=0),
            jnp.zeros((SR_COLS - len(all_cols), out_capacity), jnp.float32),
        ],
        axis=0,
    )  # (SR_COLS, T) contiguous row writes
    eye = jnp.eye(SR_COLS, dtype=jnp.float32)
    shade_rec = jax.lax.dot_general(
        stacked, eye, (((0,), (0,)), ((), ())), precision="highest"
    )  # (T, SR_COLS)

    clip = cm_s
    if want_soup_attrs:
        wn_blk = _rows_from_cols(wn_cols)  # (T, 9)
        uv_blk = _rows_from_cols(uv_cols)  # (T, 6)
        tan_blk = _rows_from_cols(tan_cols)  # (T, 12)
        normal = wn_blk.reshape(out_capacity, 3, 3)
        uv = uv_blk.reshape(out_capacity, 3, 2)
        tangent = tan_blk.reshape(out_capacity, 3, 4)
    else:
        normal = jnp.zeros((out_capacity, 3, 3), jnp.float32)
        uv = jnp.zeros((out_capacity, 3, 2), jnp.float32)
        tangent = jnp.zeros((out_capacity, 3, 4), jnp.float32)
    soup = TriangleSoup(
        clip=clip,
        normal=normal,
        uv=uv,
        tangent=tangent,
        instance=owner_s,
        valid=out_valid,
        count=count,
        tex_lod=tex_lod,
        tri_idx=tri_s,
    )
    return soup, shade_rec


## shade-record packing ------------------------------------------------------
# Deferred shading would otherwise do ~37 independent (H,W)-sized gathers
# (corner attrs, material scalars). Packing everything a pixel needs into ONE
# 64-float row per triangle makes shading a single contiguous row-gather:
# the (H*W, 64) output rows are 256 bytes,
# bound scalar gathers. Column layout:
SR_NORMAL = 0    # 0..8   corner normals (c0.xyz, c1.xyz, c2.xyz)
SR_UV = 9        # 9..14  corner uvs
SR_TANGENT = 15  # 15..26 corner tangents (xyzw x3)
SR_TEXLOD = 27
SR_INSTANCE = 28
SR_BASE = 29     # 29..32 base color rgba
SR_METALLIC = 33
SR_ROUGH = 34
SR_EMISSIVE = 35  # 35..37
SR_BC_LAYER = 38
SR_NM_LAYER = 39
# 40..48: oriented edge coefficients (e0:a,b,c, e1:..., e2:...) at render
# resolution — lets deferred shading re-derive barycentrics per pixel from
# the record row it already gathers, so the raster kernel stores only
# depth+id (visibility-buffer style). λ/Σλ is scale-invariant, so no
# facing-sign fixup is needed.
SR_EDGE = 40
# 49 used columns, padded to 64: aligned power-of-two rows for the 2M-index
# shade gather, and the selector dot's K stays small.
SR_COLS = 64


def build_shade_records(
    soup: TriangleSoup, scene: Scene, render_size=None
) -> jnp.ndarray:
    """(T, SR_COLS) f32 shade records (see column table above). Built AFTER
    compaction so nothing moves twice. render_size=(width, height) also
    packs SR_EDGE coefficients (needed when shading derives barycentrics
    from records — the Pallas depth+id-only raster path)."""
    t_cap = soup.instance.shape[0]
    mat_id = scene.instances.material_id[soup.instance]
    mats = scene.materials
    cols = [
        soup.normal.reshape(t_cap, 9),
        soup.uv.reshape(t_cap, 6),
        soup.tangent.reshape(t_cap, 12),
        soup.tex_lod[:, None],
        soup.instance[:, None].astype(jnp.float32),
        mats.base_color_factor[mat_id],
        mats.metallic[mat_id][:, None],
        mats.roughness[mat_id][:, None],
        mats.emissive[mat_id],
        mats.base_color_tex[mat_id][:, None].astype(jnp.float32),
        mats.normal_tex[mat_id][:, None].astype(jnp.float32),
    ]
    if render_size is not None:
        w, h = render_size
        u = pixel_homogeneous(soup.clip, w, h)  # (T, 3v, 3)
        e0 = jnp.cross(u[:, 1], u[:, 2])
        e1 = jnp.cross(u[:, 2], u[:, 0])
        e2 = jnp.cross(u[:, 0], u[:, 1])
        cols.append(jnp.concatenate([e0, e1, e2], axis=-1))
    rec = jnp.concatenate(cols, axis=-1)
    pad = SR_COLS - rec.shape[-1]
    return jnp.concatenate([rec, jnp.zeros((t_cap, pad), jnp.float32)], axis=-1)


def unproject_depth(
    depth: jnp.ndarray, viewproj_inv: jnp.ndarray, width: int, height: int,
    y0: int = 0, full_height: int = None, px: jnp.ndarray = None,
    py: jnp.ndarray = None,
) -> jnp.ndarray:
    """(H, W) depth + inverse viewproj -> CHANNEL-FIRST (3, H, W) world
    positions.

    Replaces storing per-triangle world positions in the draw stream: pure
    per-pixel math, no gathers. y0/full_height support row-sharded images.
    px/py (same shape as depth) override the implicit pixel-center grid with
    explicit ABSOLUTE full-image pixel-center coordinates (y0 is then
    ignored) — the checkerboard shade tier samples a non-contiguous pixel
    subset through the same math, and the flat-(P,) shade path passes
    flat-built coordinates (depth may then be any shape)."""
    if full_height is None:
        full_height = depth.shape[0]
    if px is None:
        h, w = depth.shape
        px = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + 0.5
        py = (
            jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
            + jnp.asarray(y0, jnp.float32) + 0.5
        )
    x = px / width * 2.0 - 1.0
    y = 1.0 - py / full_height * 2.0
    # plane-at-a-time FMAs (no stacked (4, H, W) intermediate + einsum)
    m = viewproj_inv
    planes = [m[i, 0] * x + m[i, 1] * y + m[i, 2] * depth + m[i, 3] for i in range(4)]
    wch = planes[3]
    inv_w = 1.0 / jnp.where(jnp.abs(wch) > 1e-12, wch, 1e-12)
    return jnp.stack([planes[0] * inv_w, planes[1] * inv_w, planes[2] * inv_w], axis=0)


def pixel_homogeneous(clip: jnp.ndarray, width: int, height: int) -> jnp.ndarray:
    """Clip (..., 4) -> pixel-homogeneous (..., 3). See ops/raster_spec.py."""
    x, y, w = clip[..., 0], clip[..., 1], clip[..., 3]
    return jnp.stack(
        [(x + w) * (0.5 * width), (w - y) * (0.5 * height), w], axis=-1
    )


def adjugate3(m: jnp.ndarray) -> jnp.ndarray:
    """Batched adjugate of (..., 3, 3)."""
    def c(i, j):  # cofactor of entry (j, i): adj = cofactor(M)^T
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        j1, j2 = (j + 1) % 3, (j + 2) % 3
        return m[..., j1, i1] * m[..., j2, i2] - m[..., j1, i2] * m[..., j2, i1]

    rows = [[c(i, j) for j in range(3)] for i in range(3)]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def triangle_setup(soup_clip: jnp.ndarray, width: int, height: int):
    """Per-triangle raster setup from clip positions (T, 3, 4).

    Returns (adj, det, zw) where
      adj: (T, 3, 3) oriented edge matrix (rows are edge fns, inside >= 0 for
           front faces after multiplying by sign(det)*FRONT_DET_SIGN upstream)
      det: (T,) raw determinant (sign = facing)
      zw:  (T, 3, 2) per-vertex (z_clip, w_clip)
    """
    u = pixel_homogeneous(soup_clip, width, height)  # (T, 3v, 3)
    m = jnp.swapaxes(u, -1, -2)  # columns are vertices
    adj = adjugate3(m)
    det = (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )
    zw = jnp.stack([soup_clip[..., 2], soup_clip[..., 3]], axis=-1)
    return adj, det, zw


def backface_cull_mask(det: jnp.ndarray) -> jnp.ndarray:
    """(T,) True for front-facing triangles (ref: generate_work.comp:132-140
    backface via determinant)."""
    return det * FRONT_DET_SIGN > 0


def ndc_bounds(soup_clip: jnp.ndarray):
    """Conservative NDC AABB per triangle -> (min_xy, max_xy), each (T, 2).

    Only valid for triangles with all w > 0; triangles crossing w=0 get a
    full-screen bound. Used for small-triangle rejection and tile binning.
    """
    w = soup_clip[..., 3]
    safe_w = jnp.where(jnp.abs(w) > 1e-9, w, 1e-9)
    ndc = soup_clip[..., :2] / safe_w[..., None]  # (T, 3, 2)
    all_front = jnp.all(w > 1e-9, axis=-1, keepdims=True)
    lo = jnp.where(all_front, jnp.min(ndc, axis=-2), -1.0)
    hi = jnp.where(all_front, jnp.max(ndc, axis=-2), 1.0)
    return lo, hi


def frustum_cull_mask(soup_clip: jnp.ndarray) -> jnp.ndarray:
    """(T,) False when the triangle is certainly outside the view volume
    (all three verts beyond one clip plane; ref: generate_work.comp NDC
    frustum reject)."""
    x, y, z, w = (soup_clip[..., i] for i in range(4))
    out = (
        jnp.all(x < -w, axis=-1)
        | jnp.all(x > w, axis=-1)
        | jnp.all(y < -w, axis=-1)
        | jnp.all(y > w, axis=-1)
        | jnp.all(z < 0, axis=-1)
        | jnp.all(z > w, axis=-1)
    )
    return ~out


def cull_triangles(soup: TriangleSoup, cull_backface: bool = True) -> TriangleSoup:
    """Apply per-triangle backface + frustum culling to the soup's valid mask
    (the generate_work.comp stage)."""
    _, det, _ = triangle_setup(soup.clip, 2, 2)  # det sign is resolution-free
    mask = soup.valid & frustum_cull_mask(soup.clip)
    if cull_backface:
        mask = mask & backface_cull_mask(det)
    else:
        mask = mask & (det != 0)
    return soup._replace(valid=mask)


def camera_clip_matrices(camera: Camera, model: jnp.ndarray):
    """(viewproj, per-instance clip matrices)."""
    _, _, vp = camera_matrices(camera)
    clip_mats = jnp.einsum("ij,njk->nik", vp, model, precision="highest")
    return vp, clip_mats
