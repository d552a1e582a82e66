"""The flagship render pipeline as a declared frame graph.

Mirrors the reference's pass chain (SURVEY.md §3.2): coarse cull ->
GPU-driven triangle cull -> raster -> shade, with the runtime switches of
RuntimeConfiguration (ecs.rs:240-277): freeze_culling (persistent soup, no
bypass copy needed), debug_aabbs (AABB box soup replaces scene geometry).
Depth prepass / shadow / PBR passes extend this graph in later stages.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from renderer_jax.graph import FrameGraph
from renderer_jax.graph.core import PlanCache
from renderer_jax.ops import debug as dbg
from renderer_jax.ops import geometry, shading
from renderer_jax.ops.cull import compact_soup
from renderer_jax.ops.geometry import TriangleSoup
from renderer_jax.ops.raster_jax import rasterize
from renderer_jax.ops.raster_pallas import TILE_H, TILE_W


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    width: int = 256
    height: int = 256
    tri_capacity: int = 16384
    # pre-cull expansion capacity (two-phase path); 0 = 2x tri_capacity
    expand_capacity_: int = 0
    # supersampling factor: render at ssaa*W x ssaa*H, box-resolve down.
    # The quality-parity replacement for the reference's 4x MSAA +
    # cmd_resolve (renderer.rs:1047-1087, 1716): no coverage hardware, so
    # SSAA. See `aa` for the production tier.
    ssaa: int = 1
    # "edge": edge-aware morphological AA on triangle-ID edges (ops/aa.py)
    # — the production anti-aliasing tier (PBR path only);
    # "none" leaves edges aliased (SSAA covers the quality-parity case).
    aa: str = "none"
    cull_backface: bool = True
    background: tuple = (0.05, 0.05, 0.08)
    shading: str = "pbr"  # "pbr" (GGX metallic-roughness) | "lambert"
    skinning: bool = False    # enable the pose pass (LBS skinning + clips)
    enable_textures: bool = True
    enable_normal_maps: bool = True
    trilinear: bool = True  # False = bilinear + nearest mip (half the taps)
    rt_scale: int = 2  # ray-traced shadow resolution divisor (rt switch)
    shadow_slots: int = 4     # atlas slots (ref: 4x4 atlas, shadow_mapping.rs)
    shadow_size: int = 512    # per-slot resolution (ref: 4096)
    # per-light caster expansion capacity (0 = tri_capacity); casters are
    # culled against each LIGHT's frustum, not the camera's
    shadow_tri_capacity: int = 0
    # amortized atlas: persist the atlas across frames, re-render only slots
    # whose light/caster signature changed (ops/shadow.py
    # render_shadow_atlas_cached). Static scenes converge to zero raster
    # work — the software-raster answer to the reference's every-frame
    # 16x4096^2 atlas (shadow_mapping.rs:22-24). False = legacy
    # re-render-all-every-frame.
    shadow_cache: bool = True
    # with shadow_cache: max dirty slots re-rendered per frame (round-robin;
    # 0 = all dirty slots immediately). Budget >=1 bounds the per-frame
    # atlas work even at the 16x4096^2 reference envelope.
    shadow_update_budget: int = 0
    # progressive sub-slot updates (requires shadow_cache and budget=1): a
    # dirty DIRECTIONAL slot refreshes as K horizontal bands, one per
    # frame, so a 4096^2 re-render never spikes one frame
    # (ops/shadow.py render_shadow_atlas_cached). Point slots still render
    # whole. 1 = off.
    shadow_progressive: int = 1
    # cluster-grain (meshlet-style) frustum/backface culling before
    # expansion. Wins on full-LOD/high-poly content where 32-triangle
    # normal cones are tight; on the LOD-heavy instancing bench it culls
    # only ~2.5% of clusters (coarse LODs make cones near-hemispheric),
    # so it defaults off and should be enabled for detailed-geometry scenes.
    cluster_cull: bool = False
    # shade only the first k light-table slots (None = whole table). The
    # reference hard-codes 2 lights in gltf_mesh.frag; here the Renderer
    # auto-specializes to the scene's live light count at construction
    # (dead table slots otherwise pay a full GGX evaluation each). Lights
    # are table-prefix-packed by SceneBuilder, so a prefix bound shades
    # every live light.
    shade_light_slots: int = None
    # static light-cast pattern: tuple of (shadow_slot, directional) per
    # shaded slot, auto-read from the scene by the Renderer (like
    # shade_light_slots). Removes the per-light casts/is_point lax.conds
    # from the shadowed shade (whose mere presence slowed the texture
    # gather).
    # None = dynamic conds (pattern may change per frame).
    static_light_casts: tuple = None
    # shade sample rate (quality knob like `trilinear`): "full" shades every
    # pixel; "checkerboard" shades the (x+y)-even half-lattice exactly and
    # reconstructs the rest from same-triangle neighbors (ops/pbr.py
    # _checkerboard_expand) — halves the two index-rate-bound 2M-row
    # gathers that dominate the shade pass; "quarter" shades only the
    # (even x, even y) lattice (ops/pbr.py _quarter_expand) — halves them
    # AGAIN (the 2x2 VRS analogue; pair with shade_fix). PBR path only.
    shade_rate: str = "full"
    # checkerboard edge fix: exactly re-shade the top P/16 reconstructed
    # pixels (ranked by same-triangle neighbor color spread) through the
    # same shading closure — with the normal-map LOD bias + Toksvig this
    # keeps the 1080p bench's min-over-poses PSNR vs the exact frame over
    # the 40 dB gate. Only applies when shade_rate="checkerboard";
    # auto-skipped under rt/rt_grid shadows (their screen-tile kernels
    # need the full lattice).
    shade_fix: bool = True
    # use the Pallas tile rasterizer (needs width % TILE_W == 0, height %
    # TILE_H == 0, tri_capacity % 256 == 0; ops/raster_pallas.py); False
    # falls back to the plain-XLA rasterizer
    use_pallas: bool = False
    # SPMD: >1 compiles THE SAME plan for an n-device mesh (instance-sharded
    # geometry + one all-gather + row-sharded raster/shade). Run through
    # Renderer(spmd_mesh=...) / shard_map; every switch works under SPMD.
    spmd_devices: int = 1
    spmd_axis: str = "sp"

    @property
    def expand_capacity(self) -> int:
        return self.expand_capacity_ or 2 * self.tri_capacity

    def __post_init__(self):
        assert self.tri_capacity % 128 == 0, "tri_capacity must be 128-aligned"
        assert self.shade_rate in ("full", "checkerboard", "quarter")
        assert self.aa in ("none", "edge")
        if self.aa == "edge":
            assert self.shading == "pbr", "edge AA is PBR-only"
        if self.shade_rate != "full":
            assert self.shading == "pbr", "shade_rate tiers are PBR-only"
            assert self.width * self.ssaa % 2 == 0
        if self.shade_rate == "quarter":
            assert self.height * self.ssaa % 2 == 0
        if self.use_pallas:
            assert (self.width * self.ssaa) % TILE_W == 0, (
                f"pallas raster needs width % {TILE_W} == 0"
            )
            assert (self.height * self.ssaa) % TILE_H == 0, (
                f"pallas raster needs height % {TILE_H} == 0"
            )
            assert self.tri_capacity % 256 == 0
        if self.shadow_progressive > 1:
            assert self.shadow_cache and self.shadow_update_budget == 1, (
                "shadow_progressive needs shadow_cache + budget=1"
            )
            assert self.shadow_size % self.shadow_progressive == 0
        if self.spmd_devices > 1:
            n = self.spmd_devices
            assert self.height * self.ssaa % (n * (TILE_H if self.use_pallas else 1)) == 0, (
                "sharded rows must divide the render height (and tile rows)"
            )
            assert self.tri_capacity % (128 * n) == 0
            assert self.expand_capacity % n == 0


def empty_soup(capacity: int) -> TriangleSoup:
    return TriangleSoup(
        clip=jnp.zeros((capacity, 3, 4), jnp.float32),
        normal=jnp.zeros((capacity, 3, 3), jnp.float32),
        uv=jnp.zeros((capacity, 3, 2), jnp.float32),
        tangent=jnp.zeros((capacity, 3, 4), jnp.float32),
        instance=jnp.zeros((capacity,), jnp.int32),
        valid=jnp.zeros((capacity,), bool),
        count=jnp.zeros((), jnp.int32),
        tex_lod=jnp.zeros((capacity,), jnp.float32),
        tri_idx=jnp.zeros((capacity,), jnp.int32),
    )


def _empty_vis(width: int, height: int):
    from renderer_jax.ops.raster_jax import VisibilityBuffer
    from renderer_jax.ops.raster_spec import DEPTH_CLEAR, NO_TRIANGLE

    return VisibilityBuffer(
        depth=jnp.full((height, width), DEPTH_CLEAR, jnp.float32),
        tri_id=jnp.full((height, width), NO_TRIANGLE, jnp.int32),
        bary=jnp.zeros((3, height, width), jnp.float32),
    )


def build_forward_graph(cfg: PipelineConfig) -> FrameGraph:
    # internal (supersampled) render resolution
    rw, rh = cfg.width * cfg.ssaa, cfg.height * cfg.ssaa
    # SPMD: the SAME graph compiles for an n-device mesh — pass bodies shard
    # instances (geometry) and rows (raster/shade) by axis_index and insert
    # the one all-gather; no second pipeline (ref: the frame graph IS the
    # product, SURVEY §1)
    SP = cfg.spmd_devices > 1
    n_dev = cfg.spmd_devices
    axis = cfg.spmd_axis
    shard_rows = rh // n_dev
    if SP:
        assert cfg.use_pallas, (
            "SPMD requires the Pallas rasterizer (binning handles the "
            "gathered draw stream's segmented valid mask)"
        )

    import jax

    def _dev_start(total):
        return jax.lax.axis_index(axis) * (total // n_dev)

    def _gather(x):
        """all-gather a per-device block along its leading axis."""
        if x.ndim == 0:
            return x
        gathered = jax.lax.all_gather(x, axis)
        return gathered.reshape((-1,) + x.shape[1:])

    g = FrameGraph("forward")
    g.switch(
        "freeze_culling", "debug_aabbs", "shadows", "occlusion_culling", "rt",
        "hud", "reference_image",
    )

    g.resource("scene", external=True, desc="Scene pytree (SoA)")
    g.resource("camera", external=True, desc="Camera")
    g.resource("time", external=True, desc="animation clock (seconds)")
    g.resource("overlay", external=True, desc="2D overlay tables (ops/overlay.py)")
    g.resource("scene_view", desc="scene after the pose pass (skinned verts)")
    g.resource("prepared", desc="(model, viewproj, clip_mats, visible, lod)")
    g.resource("soup", desc="post-cull transformed triangle stream (transient)")
    g.resource("shade_rec", desc="(T,SR_COLS) packed per-triangle shade records")
    g.resource(
        "draw_list",
        persistent=True,
        init=lambda: geometry.DrawList.empty(cfg.tri_capacity),
        desc="camera-independent culled (instance, tri) list; freeze target",
    )
    if SP:
        from jax.sharding import PartitionSpec as _P

        from renderer_jax.ops.raster_jax import VisibilityBuffer as _VB

        vis_specs = _VB(depth=_P(axis), tri_id=_P(axis), bary=_P(None, axis))
    else:
        vis_specs = None
    g.resource(
        "vis",
        persistent=True,
        init=lambda: _empty_vis(rw, rh),
        spmd_specs=vis_specs,
        desc="visibility buffer (depth, tri_id, bary); persistent so frame "
        "N-1's depth feeds the occlusion-culling pyramid via reads_prev "
        "(row-sharded across the mesh under SPMD)",
    )
    g.resource(
        "prev_vp",
        persistent=True,
        init=lambda: jnp.eye(4, dtype=jnp.float32),
        desc="this frame's viewproj, persisted so occlusion culling can "
        "reproject against frame N-1's depth in its own camera space "
        "(identity init is safe: the initial depth buffer is all-far, so "
        "nothing can be occlusion-culled on frame 1)",
    )
    g.resource("shadow", desc="(atlas depth (n_slots,S,S), light mats (L,4,4))")
    if cfg.shadow_cache:
        from renderer_jax.ops.shadow import SIG_C

        sig_shape = (
            (cfg.shadow_slots, SIG_C) if cfg.shadow_progressive <= 1
            else (cfg.shadow_slots, cfg.shadow_progressive, SIG_C)
        )
        g.resource(
            "shadow_cache",
            persistent=True,
            init=lambda: (
                jnp.ones((cfg.shadow_slots, cfg.shadow_size, cfg.shadow_size),
                         jnp.float32),
                jnp.full(sig_shape, jnp.nan, jnp.float32),
                jnp.zeros((), jnp.int32),
            ),
            desc="amortized shadow atlas state: (atlas, per-unit signature "
            "— per slot, or per (slot, band) when shadow_progressive>1 — "
            "and the round-robin cursor); NaN signatures = everything "
            "dirty on frame 1",
        )
    g.resource("image", desc="linear RGB framebuffer (output resolution)")
    g.resource("image_pre", desc="framebuffer before the overlay/present pass")
    if cfg.ssaa > 1:
        g.resource("image_hires", desc="supersampled framebuffer")

    if cfg.skinning:
        @g.pass_("pose", reads=["scene", "time"], writes=["scene_view"], queue="compute")
        def pose(scene, time):
            from renderer_jax.ops.skin import pose_scene

            return {"scene_view": pose_scene(scene, time)}
    else:
        @g.pass_("pose", reads=["scene"], writes=["scene_view"])
        def pose(scene):
            return {"scene_view": scene}

    @g.pass_("prepare", reads=["scene_view", "camera"], writes=["prepared", "prev_vp"])
    def prepare(scene_view, camera):
        """Model/clip matrices + coarse cull + LOD + scene bounds in one
        column-math computation (geometry.prepare_frame_columns)."""
        prepared = geometry.prepare_frame_columns(scene_view, camera)
        return {"prepared": prepared, "prev_vp": prepared[1]}

    def _cull_body(scene, prepared, visible):
        model, vp, clip_mats, _, lod = prepared[:5]
        if SP:
            # instance-parallel: each device culls+expands its instance
            # columns, then ONE all-gather joins the culled streams
            # (gathered valid masks are segmented, not a prefix — the Pallas
            # binning consumes them directly)
            import jax.numpy as jnp

            from renderer_jax.ops.geometry import SR_INSTANCE

            n_inst = scene.instances.mesh_id.shape[0]
            shard = n_inst // n_dev
            dev = jax.lax.axis_index(axis)
            # STRIDED instance sharding (local i <- global dev + n*i):
            # contiguous blocks concentrate one mesh's instances on one
            # device and overflow its per-device capacity; striding balances
            idx = dev + n_dev * jnp.arange(shard, dtype=jnp.int32)

            def sl(x):
                return x[idx]

            inst = scene.instances
            inst_s = inst._replace(
                translation=sl(inst.translation), rotation=sl(inst.rotation),
                scale=sl(inst.scale), mesh_id=sl(inst.mesh_id),
                material_id=sl(inst.material_id), alive=sl(inst.alive),
            )
            soup, rec = geometry.build_draw_stream(
                scene._replace(instances=inst_s),
                sl(visible), sl(lod), sl(clip_mats), sl(model),
                cfg.expand_capacity // n_dev, cfg.tri_capacity // n_dev,
                rw, rh, cull_backface=cfg.cull_backface,
                want_soup_attrs=(cfg.shading != "pbr"),
                camera_pos=prepared[8] if cfg.cluster_cull else None,
                vp=prepared[1],
            )
            # lift shard-local instance ids to global
            soup = soup._replace(instance=soup.instance * n_dev + dev)
            rec = rec.at[:, SR_INSTANCE].set(
                rec[:, SR_INSTANCE] * n_dev + dev.astype(jnp.float32)
            )
            soup = geometry.TriangleSoup(
                clip=_gather(soup.clip), normal=_gather(soup.normal),
                uv=_gather(soup.uv), tangent=_gather(soup.tangent),
                instance=_gather(soup.instance), valid=_gather(soup.valid),
                count=jax.lax.psum(soup.count, axis),
                tex_lod=_gather(soup.tex_lod), tri_idx=_gather(soup.tri_idx),
            )
            rec = _gather(rec)
        elif cfg.use_pallas:
            # fused column-math build: wide tri-record gather + fused shade
            # records; soup attrs materialize only when a consumer needs them
            soup, rec = geometry.build_draw_stream(
                scene, visible, lod, clip_mats, model,
                cfg.expand_capacity, cfg.tri_capacity,
                rw, rh, cull_backface=cfg.cull_backface,
                want_soup_attrs=(cfg.shading != "pbr"),
                camera_pos=prepared[8] if cfg.cluster_cull else None,
                vp=prepared[1],
            )
        else:
            soup = geometry.expand_draw_stream(
                scene, visible, lod, clip_mats, model, cfg.tri_capacity
            )
            soup = geometry.cull_triangles(soup, cull_backface=cfg.cull_backface)
            soup = compact_soup(soup)
            soup = geometry.finalize_tex_lod(
                soup, rw, rh, scene.atlas.level_size[0]
            )
            rec = geometry.build_shade_records(soup, scene)
        dl = geometry.DrawList(
            owner=soup.instance, tri_idx=soup.tri_idx, valid=soup.valid,
            count=soup.count,
        )
        return {"soup": soup, "draw_list": dl, "shade_rec": rec}

    @g.pass_(
        "cull",
        reads=["scene_view", "prepared"],
        writes=["soup", "draw_list", "shade_rec"],
        condition=["!freeze_culling", "!debug_aabbs", "!occlusion_culling"],
        queue="compute",
    )
    def cull(scene_view, prepared):
        return _cull_body(scene_view, prepared, prepared[3])

    @g.pass_(
        "cull_occluded",
        reads=["scene_view", "prepared"],
        reads_prev=["vis", "prev_vp"],
        writes=["soup", "draw_list", "shade_rec"],
        condition=["!freeze_culling", "!debug_aabbs", "occlusion_culling"],
        queue="compute",
    )
    def cull_occluded(scene_view, prepared, vis_prev, prev_vp_prev):
        """Two-pass occlusion culling: refine instance visibility against
        frame N-1's depth pyramid, projected with frame N-1's viewproj
        (ops/occlusion.py). Under SPMD the prev depth is row-sharded, and
        instance AABBs project anywhere — gather the full depth first."""
        from renderer_jax.ops.occlusion import occlusion_cull

        depth_prev = _gather(vis_prev.depth) if SP else vis_prev.depth
        model = prepared[0]
        visible = occlusion_cull(
            scene_view, model, prev_vp_prev, prepared[3], depth_prev
        )
        return _cull_body(scene_view, prepared, visible)

    @g.pass_(
        "transform_frozen",
        reads=["scene_view", "prepared", "draw_list"],
        writes=["soup", "shade_rec"],
        condition=["freeze_culling", "!debug_aabbs"],
        queue="compute",
    )
    def transform_frozen(scene_view, prepared, draw_list):
        """Freeze-culling path: re-transform last frame's draw list under the
        CURRENT camera (ref: cull_pass_bypass keeps the culled index buffers
        while the vertex shader uses the live MVP)."""
        scene = scene_view
        model, vp, clip_mats, visible, lod = prepared[:5]
        soup = geometry.soup_from_draw_list(scene, draw_list, clip_mats, model)
        soup = geometry.finalize_tex_lod(
            soup, rw, rh, scene.atlas.level_size[0]
        )
        rec = geometry.build_shade_records(
            soup, scene, render_size=(rw, rh) if cfg.use_pallas else None
        )
        return {"soup": soup, "shade_rec": rec}

    @g.pass_(
        "aabb_soup",
        reads=["scene_view", "prepared"],
        writes=["soup"],
        condition="debug_aabbs",
        queue="compute",
    )
    def aabb(scene_view, prepared):
        scene = scene_view
        model, vp, clip_mats, visible, lod = prepared[:5]
        soup = dbg.aabb_soup(scene, visible, clip_mats, model, cfg.tri_capacity)
        return {"soup": compact_soup(soup)}

    def _raster_body(soup, with_bary: bool):
        if cfg.use_pallas:
            from renderer_jax.ops.raster_pallas import rasterize_pallas

            vis = rasterize_pallas(
                soup.clip,
                soup.valid,
                rw,
                shard_rows if SP else rh,
                cull_backface=cfg.cull_backface,
                with_bary=with_bary,
                y0=_dev_start(rh) if SP else 0,
                full_height=rh if SP else None,
            )
        else:
            vis = rasterize(
                soup.clip,
                soup.valid,
                rw,
                rh,
                cull_backface=cfg.cull_backface,
                count=soup.count,
            )
        return {"vis": vis}

    # PBR shading re-derives barycentrics from the record's edge columns, so
    # the Pallas kernel can skip its three bary accumulators; the debug view
    # interpolates soup attributes and still needs them.
    @g.pass_("raster", reads=["soup"], writes=["vis"], condition=["!debug_aabbs"])
    def raster(soup):
        return _raster_body(soup, with_bary=(cfg.shading != "pbr"))

    @g.pass_("raster_dbg", reads=["soup"], writes=["vis"], condition=["debug_aabbs"])
    def raster_dbg(soup):
        return _raster_body(soup, with_bary=True)

    if cfg.shadow_cache:
        @g.pass_(
            "shadow_pass",
            reads=["scene_view", "prepared"],
            reads_prev=["shadow_cache"],
            writes=["shadow", "shadow_cache"],
            condition=["shadows", "!debug_aabbs"],
            queue="graphics",
        )
        def shadow_pass(scene_view, prepared, shadow_cache_prev):
            scene = scene_view
            from renderer_jax.ops.shadow import (
                light_matrices_cube,
                render_shadow_atlas_cached,
            )

            model, lod = prepared[0], prepared[4]
            scene_min, scene_max = prepared[5], prepared[6]
            mats = light_matrices_cube(scene.lights, scene_min, scene_max)
            atlas, new_cache = render_shadow_atlas_cached(
                scene, mats, scene.lights, model, lod,
                cfg.shadow_slots, cfg.shadow_size,
                cfg.shadow_tri_capacity or cfg.tri_capacity,
                prev=shadow_cache_prev,
                budget=cfg.shadow_update_budget,
                progressive=cfg.shadow_progressive,
                use_pallas=cfg.use_pallas,
                scene_min=scene_min, scene_max=scene_max,
            )
            return {"shadow": (atlas, mats), "shadow_cache": new_cache}
    else:
        @g.pass_(
            "shadow_pass",
            reads=["scene_view", "prepared"],
            writes=["shadow"],
            condition=["shadows", "!debug_aabbs"],
            queue="graphics",
        )
        def shadow_pass(scene_view, prepared):
            scene = scene_view
            from renderer_jax.ops.shadow import (
                light_matrices_cube,
                render_shadow_atlas_per_light,
            )

            model, lod = prepared[0], prepared[4]
            scene_min, scene_max = prepared[5], prepared[6]
            mats = light_matrices_cube(scene.lights, scene_min, scene_max)
            atlas = render_shadow_atlas_per_light(
                scene, mats, scene.lights, model, lod,
                cfg.shadow_slots, cfg.shadow_size,
                cfg.shadow_tri_capacity or cfg.tri_capacity,
                use_pallas=cfg.use_pallas,
                scene_min=scene_min, scene_max=scene_max,
            )
            return {"shadow": (atlas, mats)}

    def _shade(vis, soup, shade_rec, scene, camera, prepared, shadow=None, rt=None,
               rt_grid=None):
        vp_inv = prepared[7]
        y0 = _dev_start(rh) if SP else 0
        fh = rh if SP else None
        if cfg.shading == "pbr":
            from renderer_jax.ops.pbr import shade_pbr

            return shade_pbr(
                vis, shade_rec, scene, camera.position, viewproj_inv=vp_inv,
                shadow=shadow, rt=rt, rt_grid=rt_grid, background=cfg.background,
                enable_textures=cfg.enable_textures,
                enable_normal_maps=cfg.enable_normal_maps,
                trilinear=cfg.trilinear,
                bary_from_records=cfg.use_pallas,
                y0=y0, full_height=fh,
                light_slots=cfg.shade_light_slots,
                checkerboard=(cfg.shade_rate == "checkerboard"),
                quarter=(cfg.shade_rate == "quarter"),
                shade_fix=cfg.shade_fix,
                aa=(cfg.aa == "edge"),
                # () opts OUT of the static specialization (keeps the
                # dynamic per-light casts/is_point lax.conds — for scenes
                # whose cast pattern changes at render() time)
                static_casts=cfg.static_light_casts or None,
                halo_axis=axis if SP else None,
            )
        img = shading.shade_lambert(
            vis, soup, scene, camera.position, viewproj_inv=vp_inv,
            background=cfg.background, y0=y0, full_height=fh,
        )
        return img

    img_res = "image_hires" if cfg.ssaa > 1 else "image_pre"

    @g.pass_(
        "shade",
        reads=["vis", "soup", "shade_rec", "scene_view", "camera", "prepared"],
        writes=[img_res],
        condition=["!debug_aabbs", "!shadows", "!rt"],
    )
    def shade(vis, soup, shade_rec, scene_view, camera, prepared):
        return {img_res: _shade(vis, soup, shade_rec, scene_view, camera, prepared)}

    @g.pass_(
        "shade_shadowed",
        reads=["vis", "soup", "shade_rec", "scene_view", "camera", "shadow", "prepared"],
        writes=[img_res],
        condition=["!debug_aabbs", "shadows", "!rt"],
    )
    def shade_shadowed(vis, soup, shade_rec, scene_view, camera, shadow, prepared):
        return {img_res: _shade(vis, soup, shade_rec, scene_view, camera, prepared, shadow=shadow)}

    @g.pass_(
        "shade_rt",
        reads=["vis", "soup", "shade_rec", "scene_view", "camera", "prepared"],
        writes=[img_res],
        condition=["!debug_aabbs", "rt"],
    )
    def shade_rt(vis, soup, shade_rec, scene_view, camera, prepared):
        """RT switch: shadow-map lookups replaced by ray-traced shadows (the
        reference's `rt` toggle swapping to ray-query, gltf_mesh.frag).

        Pallas configs use the accelerated light-space-grid traversal with
        PER-LIGHT caster expansion (ops/rt_grid.py — off-camera casters
        occlude, Sponza-class caster counts); the XLA fallback keeps the
        brute-force matmul Moller-Trumbore over the camera stream."""
        if cfg.use_pallas:
            from renderer_jax.ops.shadow import directional_light_matrices

            scene = scene_view
            model, lod = prepared[0], prepared[4]
            smin, smax = prepared[5], prepared[6]
            mats = directional_light_matrices(scene.lights, smin, smax)
            radius = jnp.linalg.norm(smax - smin) * 0.5 + 1e-3
            rt_grid = (
                mats, lod, model, radius,
                cfg.shadow_tri_capacity or cfg.tri_capacity,
                cfg.shadow_slots,
                cfg.rt_scale,  # production tier: 1/s-res trace + ID upsample
            )
            return {img_res: _shade(
                vis, soup, shade_rec, scene_view, camera, prepared, rt_grid=rt_grid
            )}
        from renderer_jax.ops.rt import triangles_world

        vp_inv = prepared[7]
        tri_w = triangles_world(soup.clip, vp_inv)
        # the SPMD-gathered stream's valid mask is segmented, not a prefix:
        # bound the ray loop by capacity (masks stay exact)
        cnt = jnp.int32(cfg.tri_capacity) if SP else soup.count
        rt = (tri_w, soup.valid, cnt, cfg.shadow_slots, cfg.rt_scale)
        return {img_res: _shade(vis, soup, shade_rec, scene_view, camera, prepared, rt=rt)}

    if cfg.ssaa > 1:
        @g.pass_("resolve", reads=["image_hires"], writes=["image_pre"])
        def resolve(image_hires):
            """SSAA box resolve (the cmd_resolve_image analogue)."""
            k = cfg.ssaa
            h, w, c = image_hires.shape
            out = image_hires.reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))
            return {"image_pre": out}

    @g.pass_(
        "shade_debug",
        reads=["vis", "soup"],
        writes=[img_res],
        condition="debug_aabbs",
    )
    def shade_debug(vis, soup):
        return {img_res: shading.shade_flat_instance(vis, soup, background=cfg.background)}

    # -- overlay / present (the imgui pass + final blit) ---------------------
    def _assemble(image_pre):
        """Under SPMD: join the row shards so 'image' is the full replicated
        frame (the final all-gather; ~one frame of traffic)."""
        return _gather(image_pre) if SP else image_pre

    @g.pass_(
        "present", reads=["image_pre"], writes=["image"],
        condition=["!hud", "!reference_image"],
    )
    def present(image_pre):
        """Identity blit (fused away by XLA) — keeps 'image' single-writer
        per plan while the hud/reference_image switches swap the producer."""
        return {"image": _assemble(image_pre)}

    @g.pass_(
        "reference_view",
        reads=["image_pre", "soup", "shade_rec", "scene_view", "camera", "prepared"],
        writes=["image"],
        condition=["reference_image", "!hud", "!debug_aabbs"],
    )
    def reference_view(image_pre, soup, shade_rec, scene_view, camera, prepared):
        """Runtime A/B: shade the SAME culled stream through the independent
        XLA scan rasterizer at 1/4 resolution and composite a diff heatmap
        over the main image (the reference's reference_rt switch blits its
        compute-raytraced frame over the output for eyeballing,
        reference_raytracer.rs:34-93, renderer.rs:1746-1786). Gross breakage
        (winding, culling, precision) shows as magenta; the expected
        low-res/edge disagreement stays below the tint threshold."""
        from renderer_jax.ops.pbr import shade_pbr
        from renderer_jax.ops.raster_jax import rasterize

        k = 4
        wlo, hlo = cfg.width // k, cfg.height // k
        vis_lo = rasterize(
            soup.clip, soup.valid, wlo, hlo,
            cull_backface=cfg.cull_backface, count=soup.count,
        )
        ref = shade_pbr(
            vis_lo, shade_rec, scene_view, camera.position,
            viewproj_inv=prepared[7], background=cfg.background,
            enable_textures=cfg.enable_textures,
            enable_normal_maps=cfg.enable_normal_maps,
            trilinear=cfg.trilinear,
            bary_from_records=False,  # the independent path: raster barys
        )
        main = _assemble(image_pre)
        ref_up = jnp.repeat(jnp.repeat(ref, k, axis=0), k, axis=1)
        ref_up = ref_up[: main.shape[0], : main.shape[1]]
        # downsample main to the reference grid for a fair diff, then
        # broadcast the per-cell heat back up (kills upsample-edge noise)
        mlo = main[: hlo * k, : wlo * k].reshape(hlo, k, wlo, k, 3).mean(axis=(1, 3))
        heat = jnp.abs(mlo - ref).mean(axis=-1)  # (hlo, wlo)
        heat_up = jnp.repeat(jnp.repeat(heat, k, axis=0), k, axis=1)
        heat_up = heat_up[: main.shape[0], : main.shape[1]]
        tint = jnp.asarray([1.0, 0.0, 1.0], jnp.float32)
        mask = (heat_up > 0.08)[..., None]
        out = jnp.where(mask, 0.35 * main + 0.65 * tint, main)
        return {"image": out}

    @g.pass_("overlay_pass", reads=["image_pre", "overlay"], writes=["image"],
             condition="hud")
    def overlay_pass(image_pre, overlay):
        from renderer_jax.ops.overlay import build_font_atlas, compose_overlay

        font = jnp.asarray(build_font_atlas())
        return {"image": compose_overlay(_assemble(image_pre), overlay, font)}

    return g


def forward_plan_cache(cfg: PipelineConfig) -> PlanCache:
    return PlanCache(build_forward_graph(cfg), outputs=["image", "vis"])
