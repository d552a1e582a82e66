"""Shadow mapping: depth-only raster into a slot atlas + PCF lookup.

The reference renders a 4x4 atlas of 4096^2 depth slots, one per light, with
direct draws and slope-scaled-bias sampler2DShadow lookups
(src/renderer/systems/shadow_mapping.rs, gltf_mesh.vert:48-58).
Here the atlas is a (n_slots, S, S) depth array written by the same
rasterizer in depth-only mode, and the lookup is a 2x2 PCF gather during
deferred shading.

Casters are culled and expanded PER LIGHT against the light's own frustum
(render_shadow_atlas_per_light), so off-camera geometry still casts into
view — matching the reference, which renders each light's slot from its own
draw set (shadow_mapping.rs:345-491).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from renderer_jax.mathx.camera import look_at, orthographic
from renderer_jax.ops.raster_jax import rasterize
from renderer_jax.scene.types import Lights


# cube-face packing inside one (S, S) atlas slot: 2 cols x 3 rows of
# (S//2, S//4) faces (bottom S//4 band unused). Faces are fov-90 perspective
# cameras in axis order +x,-x,+y,-y,+z,-z; selection = major axis of the
# light->receiver direction. NOTE: the square fov-90 image lands in a 2:1
# viewport, so vertical texel density is half the horizontal; write and read
# mappings agree (correct), and the texel_pt bias uses the coarser fh
# density, which is the conservative choice.
CUBE_FACE_DIRS = (
    (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
    (0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
)
CUBE_FACE_UPS = (
    (0.0, 1.0, 0.0), (0.0, 1.0, 0.0),
    (0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
    (0.0, 1.0, 0.0), (0.0, 1.0, 0.0),
)


def light_matrices_cube(lights: Lights, scene_min, scene_max) -> jnp.ndarray:
    """(L, 6, 4, 4) per-light face view-projs.

    Directional lights: the fitted orthographic matrix replicated across all
    6 faces (lookups use face 0). Point lights: six fov-90 perspective
    cameras at the light position — the cube-map equivalent, packed into one
    atlas slot (the reference renders single-face per-light MVPs only;
    this exceeds it)."""
    from renderer_jax.mathx.camera import perspective

    center = (scene_min + scene_max) * 0.5
    radius = jnp.linalg.norm(scene_max - scene_min) * 0.5 + 1e-3

    def per_light(position, directional):
        d_dir = position / jnp.maximum(jnp.linalg.norm(position), 1e-8)
        eye_dir = center - d_dir * (radius * 2.0)
        dist = jnp.maximum(jnp.linalg.norm(center - position), radius * 0.05 + 1e-3)
        up_d = jnp.where(
            jnp.abs(d_dir[1]) > 0.95,
            jnp.array([1.0, 0.0, 0.0]),
            jnp.array([0.0, 1.0, 0.0]),
        )
        view_dir = look_at(eye_dir, eye_dir + d_dir, up_d)
        proj_dir = orthographic(radius, radius, radius * 0.5, radius * 3.5)
        m_dir = proj_dir @ view_dir

        near = jnp.maximum(radius * 1e-2, 1e-4)
        far = dist + radius
        proj_pt = perspective(jnp.pi / 2, 1.0, near, far)
        faces = []
        for f in range(6):
            d = jnp.array(CUBE_FACE_DIRS[f])
            up = jnp.array(CUBE_FACE_UPS[f])
            view = look_at(position, position + d, up)
            faces.append(proj_pt @ view)
        m_pt = jnp.stack(faces)  # (6, 4, 4)
        return jnp.where(directional, jnp.broadcast_to(m_dir, (6, 4, 4)), m_pt)

    mats = jax.vmap(per_light)(lights.position, lights.directional)
    want = lights.alive & (lights.shadow_slot >= 0)
    return jnp.where(
        want[:, None, None, None], mats, jnp.eye(4, dtype=jnp.float32)
    )


def directional_light_matrices(lights: Lights, scene_min, scene_max) -> jnp.ndarray:
    """(L, 4, 4) light view-proj per light (identity for non-shadow lights).

    Directional lights: orthographic box fitted around the scene AABB,
    looking along the light direction from outside the scene.
    Point lights: a perspective camera at the light position aimed at the
    scene center, fov fitted to the scene's bounding sphere (the SINGLE-FACE
    variant — used by the directional-only rt path; the shadow-map path
    uses light_matrices_cube).
    """
    from renderer_jax.mathx.camera import perspective

    center = (scene_min + scene_max) * 0.5
    radius = jnp.linalg.norm(scene_max - scene_min) * 0.5 + 1e-3

    def per_light(position, directional):
        # directional: position is the direction
        d_dir = position / jnp.maximum(jnp.linalg.norm(position), 1e-8)
        eye_dir = center - d_dir * (radius * 2.0)
        to_c = center - position
        dist = jnp.maximum(jnp.linalg.norm(to_c), radius * 0.1 + 1e-3)
        eye = jnp.where(directional, eye_dir, position)
        look_dir = jnp.where(directional, d_dir, to_c / dist)
        up = jnp.where(
            jnp.abs(look_dir[1]) > 0.95,
            jnp.array([1.0, 0.0, 0.0]),
            jnp.array([0.0, 1.0, 0.0]),
        )
        view = look_at(eye, eye + look_dir, up)
        proj_dir = orthographic(radius, radius, radius * 0.5, radius * 3.5)
        fov = 2.0 * jnp.arctan(radius / dist)
        fov = jnp.clip(fov, 0.2, 2.8)
        proj_pt = perspective(fov, 1.0, jnp.maximum(dist - radius, radius * 0.02), dist + radius)
        proj = jnp.where(directional, proj_dir, proj_pt)
        return proj @ view

    mats = jax.vmap(per_light)(lights.position, lights.directional)
    want = lights.alive & (lights.shadow_slot >= 0)
    return jnp.where(want[:, None, None], mats, jnp.eye(4, dtype=jnp.float32))


def lod_by_distance(
    scene, model: jnp.ndarray, point: jnp.ndarray, bias: float = 0.0
) -> jnp.ndarray:
    """(N,) i32 per-instance LOD picked by distance from `point` (a light
    position) — the reference picks each shadow caster's LOD by distance to
    the LIGHT, not the camera (shadow_mapping.rs:462 pick_lod(...,
    light_position, mesh_position)), so near-light/far-camera casters shadow
    at full detail. Same coverage formula as the camera pick
    (geometry.prepare_frame_columns) with the light as the eye.

    bias: extra LOD levels for RESOLUTION-aware shadow caster detail. The
    reference's pick is calibrated for its 4096^2 slots; a smaller slot's
    texel footprint is proportionally larger, so its casters deserve
    log2(4096/slot_size) coarser LODs — at the bench's 512^2 slots the
    unbiased pick wanted ~460k caster triangles for a 262k-texel target
    (silently truncated at the 131k caster capacity)."""
    from renderer_jax.ops.geometry import mats44

    model = mats44(model)
    lib = scene.meshes
    inst = scene.instances
    mn = lib.mesh_aabb_min[inst.mesh_id]  # (N, 3)
    mx = lib.mesh_aabb_max[inst.mesh_id]
    c_loc = (mn + mx) * 0.5
    cw = (
        jnp.einsum("nij,nj->ni", model[:, :3, :3], c_loc, precision="highest")
        + model[:, :3, 3]
    )
    s = jnp.linalg.norm(model[:, :3, 0], axis=-1)  # uniform scale
    radius = jnp.linalg.norm(mx - mn, axis=-1) * 0.5 * s
    dist = jnp.linalg.norm(cw - point[None], axis=-1)
    ratio = radius / jnp.maximum(dist, 1e-6)
    lod = jnp.floor(
        jnp.log2(jnp.maximum(0.25 / jnp.maximum(ratio, 1e-6), 1.0)) + bias
    )
    return jnp.clip(lod, 0, lib.lod_tri_count.shape[1] - 1).astype(jnp.int32)


def shadow_lod_bias(slot_size: int) -> float:
    """Resolution-aware caster LOD bias for a slot_size^2 atlas slot (0 at
    the reference's 4096^2 design point, shadow_mapping.rs:22-24)."""
    import math

    return max(0.0, math.log2(4096.0 / slot_size))


def shadow_caster_truncation(
    scene,
    model: jnp.ndarray,
    lod: jnp.ndarray,
    light_mats: jnp.ndarray,  # (L, 6, 4, 4) from light_matrices_cube
    n_slots: int,
    caster_capacity: int,
    slot_size: int = 4096,  # resolution-aware caster LOD (shadow_lod_bias)
    scene_min=None,         # scene AABB: match the render path's
    scene_max=None,         # camera-independent directional LOD pick
) -> jnp.ndarray:
    """(n_slots,) i32 — shadow casters DROPPED per slot this frame.

    expand_clip_only silently clamps each light's caster stream at
    caster_capacity; a dropped off-camera caster shows up only as a missing
    shadow, so the HUD surfaces the per-slot deficit (the same
    observability contract as the raster bin-overflow counter). Point
    lights report their worst face."""
    from renderer_jax.ops.geometry import coarse_cull

    lights = scene.lights
    inst = scene.instances
    lib = scene.meshes

    def demand(visible, lod_pick):
        tc = jnp.where(visible, lib.lod_tri_count[inst.mesh_id, lod_pick], 0)
        return jnp.sum(tc)

    out = []
    for slot in range(n_slots):
        match = (lights.shadow_slot == slot) & lights.alive
        li = jnp.argmax(match)
        active = jnp.any(match)
        is_point = active & ~lights.directional[li]

        def directional(_):
            vis = coarse_cull(scene, model, light_mats[li, 0]) & active
            if scene_min is not None:
                # match the render path's camera-independent,
                # resolution-aware pick (directional branch of
                # render_shadow_atlas_per_light)
                center = (scene_min + scene_max) * 0.5
                radius = jnp.linalg.norm(scene_max - scene_min) * 0.5 + 1e-3
                d_dir = lights.position[li] / jnp.maximum(
                    jnp.linalg.norm(lights.position[li]), 1e-8
                )
                eye = center - d_dir * (radius * 2.0)
                lod_d = lod_by_distance(
                    scene, model, eye, bias=shadow_lod_bias(slot_size)
                )
            else:
                lod_d = lod  # legacy: the camera pick
            return demand(vis, lod_d)

        def point(_):
            lod_l = lod_by_distance(
                scene, model, lights.position[li],
                bias=shadow_lod_bias(slot_size),
            )
            worst = jnp.int32(0)
            for f in range(6):
                vis = coarse_cull(scene, model, light_mats[li, f]) & active
                worst = jnp.maximum(worst, demand(vis, lod_l))
            return worst

        d = jax.lax.cond(is_point, point, directional, operand=None)
        out.append(jnp.maximum(d - caster_capacity, 0))
    return jnp.stack(out)


def _weights(n: int, salt: float) -> jnp.ndarray:
    """(n,) deterministic pseudo-random fold weights in ~[-1, 1] (change
    detection only — collisions require exact cancellation, measure-zero)."""
    i = jnp.arange(n, dtype=jnp.float32)
    return jnp.sin(i * 12.9898 + salt * 78.233)


def _fold(x: jnp.ndarray, salt: float) -> jnp.ndarray:
    """Weighted sum of any (N, ...) array -> one f32 scalar."""
    x = x.reshape(x.shape[0], -1).astype(jnp.float32)
    n, k = x.shape
    return jnp.sum(x * _weights(n, salt)[:, None] * _weights(k, salt + 1.0)[None, :])


SIG_C = 3  # independent signature components per slot (see shadow_signature)


def band_matrix(m: jnp.ndarray, band, k: int) -> jnp.ndarray:
    """Remap NDC y of view-proj `m` so horizontal band `band` (of k equal
    bands, top to bottom) fills the whole viewport.

    With the raster spec's py = (1 - y_ndc)/2 * H mapping, the row op
    y' = k*y + (1 - k + 2*band) makes row r' of a (S/k, S) band render
    coincide exactly with row band*(S/k) + r' of the full (S, S) render
    (same pixel centers, so depth matches up to triangle-setup rounding).
    `band` may be traced. Culling against the band matrix also tightens
    the caster set to the band frustum."""
    kf = jnp.float32(k)
    cshift = 1.0 - kf + 2.0 * jnp.asarray(band, jnp.float32)
    return m.at[1].set(kf * m[1] + cshift * m[3])


def shadow_signature(
    scene, light_mats: jnp.ndarray, lights: Lights, model: jnp.ndarray,
    n_slots: int, progressive: int = 1,
) -> jnp.ndarray:
    """Per-unit f32 change-detection signatures for the amortized atlas.

    progressive=1: (n_slots, SIG_C) — one unit per slot.
    progressive=K>1: (n_slots, K, SIG_C) — each DIRECTIONAL slot splits
    into K horizontal-band units with independent signatures, so a moving
    caster dirties only the bands its AABB actually projects into and a
    band re-render costs 1/K of a slot (the progressive sub-slot update).
    Point and inactive slots track on band 0 only (bands 1..K-1 hold a constant sentinel and are never dirty).

    A unit's rendered depth is a pure function of (its light's face
    matrices, point/directional kind, active flag) x (the casters INSIDE
    its band/light frustum: model matrices, mesh ids). The mesh library
    is immutable per scene, so the signature folds the rest; any change
    -> the unit re-renders. Inactive slots get a sentinel so
    active<->inactive transitions dirty the slot exactly once.

    Design vs a single whole-scene scalar:
    - PER-LIGHT (and per-band) caster restriction: each unit's fold masks
      casters by the same coarse frustum cull the atlas render uses
      (union of the six faces for point lights; the band matrix for
      directional bands), so one moving instance dirties only the units
      whose frustum can see it. Previously the caster term was
      slot-independent and ANY motion dirtied EVERY slot — the cache
      degenerated to full per-frame cost exactly when the scene is a
      game. The mask is exact wrt the render: a caster outside the unit
      frustum cannot write the unit's depth
      (render_shadow_atlas_per_light culls with the same planes).
    - SIG_C independent salted components: a single scalar's change
      threshold scales with the magnitude of the whole-scene fold, so a
      small caster's motion could round away in a large scene. With
      SIG_C independent folds a change must round away in ALL of them; the count term is salted per instance so swaps of
      identical transforms still register."""
    from renderer_jax import mathx
    from renderer_jax.ops.geometry import mats44

    inst = scene.instances
    model44 = mats44(model)
    alive = inst.alive
    mn = scene.meshes.mesh_aabb_min[inst.mesh_id]
    mx = scene.meshes.mesh_aabb_max[inst.mesh_id]
    wmin, wmax = mathx.transform_aabb(model44, mn, mx)
    center = (wmin + wmax) * 0.5
    extent = (wmax - wmin) * 0.5
    flat = model.reshape(model.shape[0], -1).astype(jnp.float32)
    mid = inst.mesh_id.astype(jnp.float32)

    def vis_under(m):
        planes = mathx.frustum_planes(m)
        return alive & ~mathx.aabb_outside_frustum(planes, center, extent)

    salts = (2.0, 23.0, 61.0)
    assert len(salts) == SIG_C

    # the caster fold is BILINEAR in (row weights x column weights), so the
    # k-contraction hoists out of the per-unit loop: one (N,) profile per
    # salt, each unit then reduces one masked (N,) product — 16x less
    # per-unit work, which matters at progressive K x n_slots units
    # (the unhoisted folds were a standing per-frame cost at the bench's
    # dynamic config)
    n_inst = flat.shape[0]
    profiles = []
    for salt in salts:
        wk = _weights(flat.shape[1], salt + 1.0)
        g_model = (flat * wk[None, :]).sum(axis=1) * _weights(n_inst, salt)
        g_mid = (
            mid * _weights(n_inst, salt + 11.0)
            * _weights(1, salt + 12.0)[0]
        )
        g_cnt = _weights(n_inst, salt + 29.0)
        profiles.append(g_model + g_mid + g_cnt)  # (N,) per salt

    def unit_sig(li, active, directional, vis):
        """SIG_C-component fold of (light term) x (masked casters)."""
        visf = vis.astype(jnp.float32)
        comps = []
        for salt, prof in zip(salts, profiles):
            caster = jnp.sum(prof * visf)
            slot_term = (
                _fold(light_mats[li].reshape(6, 16), salt + 3.0)
                + jnp.where(directional, 17.0, 39.0)
            )
            comps.append(
                jnp.where(active, slot_term + caster, jnp.float32(-1e30))
            )
        return jnp.stack(comps)  # (SIG_C,)

    def slot_vis(li, directional):
        """Whole-light caster mask (union of the 6 faces for point)."""
        vis6 = [vis_under(light_mats[li, f]) for f in range(6)]
        vis_pt = vis6[0]
        for v in vis6[1:]:
            vis_pt = vis_pt | v
        return jnp.where(directional, vis6[0], vis_pt)

    def per_slot(slot):
        match = (lights.shadow_slot == slot) & lights.alive
        li = jnp.argmax(match)
        active = jnp.any(match)
        directional = lights.directional[li]
        if progressive <= 1:
            return unit_sig(li, active, directional, slot_vis(li, directional))
        # per-band units: directional bands get band-frustum-masked folds;
        # point/inactive slots track on band 0 (whole-light mask) and hold
        # a never-dirty sentinel on bands 1..K-1
        whole = slot_vis(li, directional)
        bands = []
        for b in range(progressive):
            m_band = band_matrix(light_mats[li, 0], b, progressive)
            vis_b = jnp.where(directional, vis_under(m_band), whole)
            s = unit_sig(li, active, directional, vis_b)
            if b > 0:
                s = jnp.where(
                    active & directional, s, jnp.float32(-2e30)
                )
            bands.append(s)
        return jnp.stack(bands)  # (K, SIG_C)

    return jax.vmap(per_slot)(jnp.arange(n_slots, dtype=jnp.int32))


def select_shadow_updates(
    sig: jnp.ndarray, sig_prev: jnp.ndarray, cursor: jnp.ndarray, budget: int
):
    """Round-robin budgeted update scheduling over dirty atlas slots.

    Returns (selected (n,) bool, new_sig, new_cursor). A slot is dirty when
    its signature changed (NaN prev, the initial state, is always dirty).
    With budget<=0 every dirty slot renders this frame; otherwise at most
    `budget` dirty slots render, picked in round-robin order starting at
    `cursor`, and the cursor advances past the last serviced slot so
    starved slots win next frame. Un-serviced dirty slots keep their OLD
    signature and stay dirty. sig may be (n,) scalar or (n, SIG_C)
    multi-component (dirty = ANY component changed)."""
    n = sig.shape[0]
    if sig.ndim == 2:
        dirty = ~jnp.all(sig == sig_prev, axis=-1)
    else:
        dirty = ~(sig == sig_prev)  # NaN prev compares unequal -> dirty
    if budget <= 0 or budget >= n:
        sel = dirty
        new_cursor = jnp.asarray(cursor, jnp.int32)
    else:
        order = jnp.mod(jnp.arange(n, dtype=jnp.int32) - cursor, n)
        pri = jnp.where(dirty, order, n + 1)
        rank = jnp.argsort(pri)
        sel_sorted = (jnp.arange(n) < budget) & (pri[rank] <= n)
        sel = jnp.zeros((n,), bool).at[rank].set(sel_sorted)
        last_order = jnp.max(jnp.where(sel, order, -1))
        new_cursor = jnp.where(
            jnp.any(sel), jnp.mod(cursor + last_order + 1, n), cursor
        ).astype(jnp.int32)
    selx = sel[:, None] if sig.ndim == 2 else sel
    new_sig = jnp.where(selx, sig, sig_prev)
    return sel, new_sig, new_cursor


def render_shadow_atlas_cached(
    scene,
    light_mats: jnp.ndarray,
    lights: Lights,
    model: jnp.ndarray,
    lod: jnp.ndarray,
    n_slots: int,
    slot_size: int,
    caster_capacity: int,
    prev,                     # persistent cache state (see docstring)
    budget: int = 0,
    progressive: int = 1,
    use_pallas: bool = False,
    scene_min=None,
    scene_max=None,
):
    """Amortized shadow atlas: re-render only slots whose inputs changed.

    The reference re-renders its whole 16x4096^2 atlas every frame inside a
    desktop-GPU budget (shadow_mapping.rs:345-491, 22-24) with hardware
    rasterization; for a software rasterizer a cold 16x4096^2 render is far
    outside a frame, so the answer here is amortization: the atlas is
    persistent frame state, a per-slot signature (shadow_signature) detects light/caster changes, and at most
    `budget` dirty slots re-render per frame (select_shadow_updates,
    round-robin). Static scenes converge to ZERO raster work; a moved light
    re-renders within ceil(dirty/budget) frames.

    State is (atlas, sig, cursor) either way.

    progressive=1 (default): sig is (n_slots, SIG_C); a selected slot
    re-renders WHOLE.

    progressive=K>1 (requires budget=1): sig is (n_slots, K, SIG_C) — each
    directional slot is K independently dirty-tracked horizontal-band
    UNITS (shadow_signature), scheduled by the same round-robin over the
    flattened unit list. A dirty 4096^2 slot never spikes one frame by a
    full re-render: each frame
    renders at most one band (~1/K of a slot), and a caster moving inside
    the light's view dirties ONLY the bands its AABB projects into. A
    moved light refreshes its K bands over K frames (standard time-sliced
    shadow lag: adjacent bands up to K frames apart while moving). Point
    and inactive slots are a single unit on band 0 (rendered whole).

    Returns (atlas, (atlas, new_sig, new_cursor))."""
    atlas_prev, sig_prev, cursor = prev
    sig = shadow_signature(
        scene, light_mats, lights, model, n_slots, progressive=progressive
    )
    if progressive <= 1:
        sel, new_sig, new_cursor = select_shadow_updates(
            sig, sig_prev, cursor, budget
        )
        atlas = render_shadow_atlas_per_light(
            scene, light_mats, lights, model, lod, n_slots, slot_size,
            caster_capacity, use_pallas=use_pallas,
            selected=sel, atlas_prev=atlas_prev,
            scene_min=scene_min, scene_max=scene_max,
        )
        return atlas, (atlas, new_sig, new_cursor)

    assert budget == 1, "progressive sub-slot updates require budget=1"
    assert slot_size % progressive == 0
    k = progressive
    # round-robin over the flattened (slot, band) unit list: at most ONE
    # unit renders per frame, so the per-slot render path can use a traced
    # band index (argmax of its selected row)
    sel_flat, new_sig_flat, new_cursor = select_shadow_updates(
        sig.reshape(n_slots * k, -1), sig_prev.reshape(n_slots * k, -1),
        cursor, 1,
    )
    sel = sel_flat.reshape(n_slots, k)
    new_sig = new_sig_flat.reshape(n_slots, k, -1)
    atlas = render_shadow_atlas_per_light(
        scene, light_mats, lights, model, lod, n_slots, slot_size,
        caster_capacity, use_pallas=use_pallas,
        selected=sel, atlas_prev=atlas_prev,
        scene_min=scene_min, scene_max=scene_max,
        progressive=progressive,
    )
    return atlas, (atlas, new_sig, new_cursor)


def render_shadow_atlas_per_light(
    scene,
    light_mats: jnp.ndarray,  # (L, 6, 4, 4) from light_matrices_cube
    lights: Lights,
    model: jnp.ndarray,       # (N, 4, 4) instance model matrices
    lod: jnp.ndarray,         # (N,) i32 per-instance LOD (camera pick)
    n_slots: int,
    slot_size: int,
    caster_capacity: int,
    use_pallas: bool = False,
    selected: jnp.ndarray = None,   # (n_slots,) bool: render only these,
    atlas_prev: jnp.ndarray = None,  # keep prev slot depth for the rest
    scene_min=None,
    scene_max=None,
    # progressive band units: selected is (n_slots, K) with at most one
    # band set per slot; directional slots render just that 1/K-height band
    progressive: int = 1,
) -> jnp.ndarray:
    """Depth atlas with PER-LIGHT caster culling + expansion.

    Each slot coarse-culls every alive instance against ITS light's frustum
    and expands its own clip-only draw stream, so casters outside the main
    camera still shadow the view (ref: shadow_mapping.rs:345-491 renders
    per-light draw sets; LOD here reuses the camera's per-instance pick
    where the reference picks by light distance). Directional slots render
    one full-slot pass; POINT lights render all six cube faces into the
    slot's 2x3 face grid (each face per-face culled+expanded). Shadow
    rasterization is two-sided. use_pallas runs the binned tile kernel per
    pass instead of the unbinned XLA scan rasterizer.

    selected/atlas_prev (the amortized-cache path): slots with
    selected[slot]==False skip the whole cull+expand+raster and return
    atlas_prev[slot] unchanged.

    scene_min/scene_max: when given, DIRECTIONAL slots pick caster LOD by
    distance from the light's virtual eye (camera-INDEPENDENT — required
    for the cache to be exact under camera motion, and matching the
    reference's light-distance pick, shadow_mapping.rs:462); when None the
    camera's `lod` pick is used (legacy behavior)."""
    from renderer_jax.ops.geometry import coarse_cull, expand_clip_only, mats44

    if progressive > 1:
        assert selected is not None and atlas_prev is not None
    model = mats44(model)
    fw, fh = slot_size // 2, slot_size // 4  # cube face viewport
    if scene_min is not None:
        center = (scene_min + scene_max) * 0.5
        radius = jnp.linalg.norm(scene_max - scene_min) * 0.5 + 1e-3

    def _raster(clip, valid, count, w, h):
        from renderer_jax.ops import raster_pallas as rp

        if use_pallas and w % rp.TILE_W == 0 and h % rp.TILE_H == 0:
            return rp.rasterize_pallas(
                clip, valid, w, h, cull_backface=False, with_bary=False,
            ).depth
        return rasterize(
            clip, valid, w, h,
            strip_rows=min(32, h), cull_backface=False, count=count,
        ).depth

    def _render_view(m, active, w, h, lod_pick):
        clip_mats = jnp.einsum("ij,njk->nik", m, model, precision="highest")
        visible = coarse_cull(scene, model, m) & active
        clip, valid, count = expand_clip_only(
            scene, visible, lod_pick, clip_mats, caster_capacity
        )
        return _raster(clip, valid, count, w, h)

    def per_slot(slot, band=None):
        match = (lights.shadow_slot == slot) & lights.alive
        li = jnp.argmax(match)
        active = jnp.any(match)
        is_point = active & ~lights.directional[li]

        def directional(_):
            if scene_min is not None:
                # camera-independent pick: LOD by distance from the light's
                # virtual eye (the ortho camera origin used by
                # light_matrices_cube) — the atlas depends only on
                # light + casters, so the cache is exact under camera orbit
                d_dir = lights.position[li] / jnp.maximum(
                    jnp.linalg.norm(lights.position[li]), 1e-8
                )
                eye = center - d_dir * (radius * 2.0)
                lod_pick = lod_by_distance(
                    scene, model, eye, bias=shadow_lod_bias(slot_size)
                )
            else:
                # legacy: ortho texel footprint is uniform, camera coverage
                # pick is a usable detail proxy (but camera-DEPENDENT)
                lod_pick = lod
            m = light_mats[li, 0]
            if progressive > 1:
                # progressive band unit: render rows [band*bh, (band+1)*bh)
                # of the slot at native density (band_matrix remaps NDC y so
                # the band fills a (bh, S) viewport with identical pixel
                # centers). Culling against the band matrix also tightens
                # the caster set to the band frustum.
                bh = slot_size // progressive
                m_band = band_matrix(m, band, progressive)
                band_depth = _render_view(m_band, active, slot_size, bh, lod_pick)
                return jax.lax.dynamic_update_slice(
                    atlas_prev[slot], band_depth,
                    (band * bh, jnp.int32(0)),
                )
            return _render_view(m, active, slot_size, slot_size, lod_pick)

        def point(_):
            # perspective: pick LOD by distance to THIS light (ref
            # shadow_mapping.rs:462) — shared across the six faces
            lod_l = lod_by_distance(
                scene, model, lights.position[li],
                bias=shadow_lod_bias(slot_size),
            )
            rows = []
            for r in range(3):
                pair = [
                    _render_view(light_mats[li, 2 * r + c], active, fw, fh, lod_l)
                    for c in range(2)
                ]
                rows.append(jnp.concatenate(pair, axis=1))  # (fh, S)
            grid = jnp.concatenate(rows, axis=0)  # (3*fh, S)
            pad = jnp.ones((slot_size - 3 * fh, slot_size), jnp.float32)
            return jnp.concatenate([grid, pad], axis=0)

        def empty(_):
            # unclaimed slot: SKIP the whole cull+expand+raster at runtime
            # (an inactive slot once rendered an all-empty stream anyway —
            # ~1/3 of the shadow pass at the bench's one-light config)
            return jnp.ones((slot_size, slot_size), jnp.float32)

        fresh = jax.lax.cond(
            active,
            lambda _: jax.lax.cond(is_point, point, directional, operand=None),
            empty,
            operand=None,
        )
        return fresh

    if selected is None:
        return jax.lax.map(per_slot, jnp.arange(n_slots, dtype=jnp.int32))

    if progressive > 1:
        def per_slot_cached(slot):
            # selected[slot] is the (K,) band row with at most one bit set
            # (the cached path's unit round-robin runs budget=1); the band
            # index can therefore be a traced argmax, keeping ONE band
            # render in the program instead of K conds per slot
            any_b = jnp.any(selected[slot])
            band = jnp.argmax(selected[slot]).astype(jnp.int32)
            return jax.lax.cond(
                any_b, lambda s: per_slot(s, band), lambda s: atlas_prev[s],
                slot,
            )
    else:
        def per_slot_cached(slot):
            # cond, not where: an unselected slot must SKIP its whole
            # cull+expand+raster chain (the point of the cache)
            return jax.lax.cond(
                selected[slot], per_slot, lambda s: atlas_prev[s], slot
            )

    return jax.lax.map(per_slot_cached, jnp.arange(n_slots, dtype=jnp.int32))


def shadow_occlusion(
    world: jnp.ndarray,      # (3, ...) channel-first — (H, W) image or (P,) flat
    ndl: jnp.ndarray,        # (1, ...) clamped n.l for slope-scaled bias
    light_mat: jnp.ndarray,  # (6, 4, 4) face matrices, or (4, 4) directional
    slot_depth: jnp.ndarray,  # (S, S)
    normal: jnp.ndarray = None,  # (3, ...) geometric normal (normal-offset)
    is_point=False,          # traced bool: cube-face lookup
    light_pos: jnp.ndarray = None,  # (3,) for the point path
    bias: float = 1e-3,
    slope_bias: float = 3e-3,
    normal_offset_texels: float = 1.5,
) -> jnp.ndarray:
    """(1, H, W) shadow factor in [0,1] with 2x2 PCF.

    Directional lights sample the full slot through face matrix 0. Point
    lights pick the cube face per pixel (major axis of light->receiver) and
    sample inside that face's sub-rect of the slot's 2x3 grid; PCF taps are
    clamped to the face so filtering never bleeds across faces.

    Acne control: receiver positions are offset along the geometric normal by
    ~1.5 shadow texels ("normal-offset shadows") plus a small slope-scaled
    depth bias — the modern replacement for the reference's purely
    slope-scaled sampler offsets (gltf_mesh.vert:48-58)."""
    s = slot_depth.shape[0]
    fw, fh = s // 2, s // 4
    if light_mat.ndim == 2:
        light_mat = jnp.broadcast_to(light_mat, (6, 4, 4))
    static_kind = is_point if isinstance(is_point, bool) else None
    is_point = jnp.asarray(is_point)
    if light_pos is None:
        light_pos = jnp.zeros((3,), jnp.float32)

    # shared: slope-scaled bias term (receiver-independent of the branch)
    slope = jnp.sqrt(jnp.maximum(1.0 - ndl[0] ** 2, 0.0)) / jnp.maximum(ndl[0], 1e-2)
    bias_term = bias + slope_bias * jnp.minimum(slope, 4.0)
    tail = world.shape[1:]  # (H, W) image or (P,) flat — shape-generic

    def _pcf(tx, ty, ref_d, inside, x_lo, x_hi, y_lo, y_hi, fw_c, fh_c):
        """2x2 PCF via a GROUP-PACKED per-texel quad table: ONE 16-lane
        row-gather per pixel. A (P, 4) f32 gather runs in the narrow-row
        regime (several times the per-index cost), so 4 consecutive texels' quads
        share one 16-lane (64 B) physical row and a 2-level lane-select
        tree picks the texel's slice — the exact recipe of the texture
        sampler's quad table (ops/texture.py _gather_quad_row). The
        table's +1 neighbors are pre-clamped (slot edge or cube-face rect, static fw_c/fh_c clamp periods); bases clamped up
        from BELOW a bound collapse both taps onto the edge texel,
        reproduced exactly by the px_in/py_in selects.

        The neighbor planes are built from contiguous SLICES + edge
        selects, not index-array gathers: `slot_depth[:, xn]` was a
        16.7M-element column gather at a 4096^2 slot."""
        x0 = jnp.floor(tx).astype(jnp.int32)
        y0 = jnp.floor(ty).astype(jnp.int32)
        fx = tx - x0
        fy = ty - y0
        ar_ = jnp.arange(s, dtype=jnp.int32)
        col_edge = (ar_ % fw_c) == fw_c - 1    # x+1 clamps at face right
        row_edge = (ar_ % fh_c) == fh_c - 1    # y+1 clamps at face bottom
        shl = jnp.concatenate(
            [slot_depth[:, 1:], slot_depth[:, -1:]], axis=1
        )
        d10_img = jnp.where(col_edge[None, :], slot_depth, shl)
        shd = jnp.concatenate(
            [slot_depth[1:, :], slot_depth[-1:, :]], axis=0
        )
        d01_img = jnp.where(row_edge[:, None], slot_depth, shd)
        d11_img = jnp.where(
            col_edge[None, :], d01_img,
            jnp.concatenate([d01_img[:, 1:], d01_img[:, -1:]], axis=1),
        )
        quad = jnp.stack(
            [
                slot_depth.reshape(-1),
                d10_img.reshape(-1),
                d01_img.reshape(-1),
                d11_img.reshape(-1),
            ],
            axis=0,
        )  # (4, S*S) contiguous rows
        eye4 = jnp.eye(4, dtype=jnp.float32)
        quad_rows = jax.lax.dot_general(
            quad, eye4, (((0,), (0,)), ((), ())), precision="highest"
        )  # (S*S, 4) row-major
        grouped = quad_rows.reshape(-1, 16)  # 4 texels per 64 B row
        x0c = jnp.clip(x0, x_lo, x_hi)
        y0c = jnp.clip(y0, y_lo, y_hi)
        flat_idx = (y0c * s + x0c).reshape(-1)
        rows16 = grouped[flat_idx >> 2]  # (P, 16) — THE gather
        # ONE transposing dot to channel-major (16, P): the lane-select tree
        # on (P, k<8) intermediates materializes padded slices; after the
        # transpose every
        # select/compare below is a dense fusable (H, W) plane op (the
        # texture sampler's channel-major relayout, made explicit).
        eye16 = jnp.eye(16, dtype=jnp.float32)
        planes16 = jax.lax.dot_general(
            eye16, rows16, (((1,), (1,)), ((), ())), precision="highest"
        ).reshape((16,) + tail)
        sub = (flat_idx & 3).reshape(tail)
        r = []
        for k in range(4):
            v = planes16[k]
            for j in range(1, 4):
                v = jnp.where(sub == j, planes16[4 * j + k], v)
            r.append(v)
        px_in = x0 >= x_lo
        py_in = y0 >= y_lo
        t00 = r[0]
        t10 = jnp.where(px_in, r[1], r[0])
        t01 = jnp.where(py_in, r[2], r[0])
        t11 = jnp.where(
            px_in & py_in, r[3],
            jnp.where(px_in, r[1], jnp.where(py_in, r[2], r[0])),
        )

        def lit_of(sample):
            return (ref_d <= sample).astype(jnp.float32)

        lit = (
            lit_of(t00) * (1 - fx) * (1 - fy)
            + lit_of(t10) * fx * (1 - fy)
            + lit_of(t01) * (1 - fx) * fy
            + lit_of(t11) * fx * fy
        )
        return jnp.where(inside, lit, 1.0)

    ar = jnp.arange(s, dtype=jnp.int32)

    def _directional():
        """Full-slot lookup through face matrix 0: no per-pixel face
        select, no 6-matrix blend (96 (H,W) ops), no distance sqrt."""
        if normal is not None:
            row_norm = jnp.linalg.norm(light_mat[0, 0, :3]) + 1e-12
            texel_dir = 2.0 / (row_norm * s)
            w2 = world + normal * (texel_dir * normal_offset_texels)
        else:
            w2 = world
        m = light_mat[0]
        clip = [
            m[i, 0] * w2[0] + m[i, 1] * w2[1] + m[i, 2] * w2[2] + m[i, 3]
            for i in range(4)
        ]
        w = jnp.where(jnp.abs(clip[3]) > 1e-9, clip[3], 1e-9)
        u = (clip[0] / w + 1.0) * 0.5
        v = (1.0 - clip[1] / w) * 0.5
        d = clip[2] / w
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (d >= 0) & (d <= 1)
        ref_d = d - bias_term
        return _pcf(
            u * s - 0.5, v * s - 0.5, ref_d, inside, 0, s - 1, 0, s - 1, s, s
        )

    def _point():
        """Cube-face lookup: per-pixel face select inside the slot's 2x3
        face grid, PCF clamped to the face rect (no cross-face bleed)."""
        lp = light_pos.reshape((3,) + (1,) * len(tail))
        if normal is not None:
            dvec = world - lp
            dist = jnp.sqrt(jnp.sum(dvec * dvec, axis=0, keepdims=True))
            texel_pt = 2.0 * dist / fh
            w2 = world + normal * (texel_pt * normal_offset_texels)
        else:
            w2 = world
        d_l = w2 - lp
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
        # blend the selected face's matrix per pixel, then one projection
        hcf = jnp.concatenate(
            [w2, jnp.ones((1,) + w2.shape[1:], jnp.float32)], axis=0
        )
        clip = []
        for i in range(4):
            plane = 0.0
            for jj in range(4):
                coeff = 0.0
                for f in range(6):
                    coeff = coeff + jnp.where(face == f, light_mat[f, i, jj], 0.0)
                plane = plane + coeff * hcf[jj]
            clip.append(plane)
        w = jnp.where(jnp.abs(clip[3]) > 1e-9, clip[3], 1e-9)
        u = (clip[0] / w + 1.0) * 0.5
        v = (1.0 - clip[1] / w) * 0.5
        d = clip[2] / w
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (d >= 0) & (d <= 1)
        ref_d = d - bias_term
        col = face % 2
        row = face // 2
        return _pcf(
            col * fw + u * fw - 0.5, row * fh + v * fh - 0.5, ref_d, inside,
            col * fw, col * fw + fw - 1, row * fh, row * fh + fh - 1, fw, fh,
        )

    # static is_point (the Renderer's light-cast specialization): pick the
    # branch at trace time — no conditional in the program at all
    if static_kind is not None:
        return (_point() if static_kind else _directional())[None]
    # cond, not where: a directional light must not pay the point path's
    # per-pixel face blend and vice versa
    return jax.lax.cond(is_point, _point, _directional)[None]  # (1, H, W)
