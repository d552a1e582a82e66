"""Amortized shadow atlas: signature dirty-tracking + budgeted round-robin.

The reference re-renders its whole 16x4096^2 atlas every frame
(shadow_mapping.rs:345-491); this design makes the atlas persistent
frame state and re-renders only slots whose light/caster signature changed,
at most `shadow_update_budget` per frame (ops/shadow.py
render_shadow_atlas_cached)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera
from renderer_jax.ops.shadow import select_shadow_updates
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives


def two_light_scene():
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    floor = b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.8)
    b.add_instance(plane, floor)
    b.add_instance(box, red, translation=(0, 0.8, 0))
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0,
                shadow_slot=0)
    b.add_light(position=(-1.0, -1.0, 0.3), directional=True, intensity=2.0,
                shadow_slot=1)
    return b.build()


def cam(angle=0.0):
    return Camera.create(
        position=jnp.array([3.0 * np.sin(angle), 6.0, 3.0 * np.cos(angle) + 0.01]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        near=0.1,
        far=50.0,
    )


CFG = PipelineConfig(width=64, height=64, tri_capacity=512, shading="pbr",
                     shadow_slots=2, shadow_size=64)


def make_renderer(scene, **cfg_kw):
    r = Renderer(scene, dataclasses.replace(CFG, **cfg_kw))
    r.set_config(shadows=True)
    r.apply_config_now()
    return r


# -- pure scheduling ---------------------------------------------------------

def test_select_updates_no_budget_renders_all_dirty():
    sig = jnp.array([1.0, 2.0, 3.0, 4.0])
    prev = jnp.array([1.0, 9.0, jnp.nan, 4.0])
    sel, new_sig, cur = jax.jit(
        lambda s, p, c: select_shadow_updates(s, p, c, 0)
    )(sig, prev, jnp.int32(0))
    np.testing.assert_array_equal(np.asarray(sel), [False, True, True, False])
    np.testing.assert_array_equal(np.asarray(new_sig), np.asarray(sig))


def test_select_updates_budget_round_robin():
    sig = jnp.array([1.0, 2.0, 3.0, 4.0])
    prev = jnp.full((4,), jnp.nan)  # everything dirty
    cursor = jnp.int32(0)
    seen = []
    for _ in range(4):
        sel, prev, cursor = select_shadow_updates(sig, prev, cursor, 1)
        picked = int(np.argmax(np.asarray(sel)))
        assert np.asarray(sel).sum() == 1
        seen.append(picked)
    assert seen == [0, 1, 2, 3], seen
    # converged: nothing dirty, cursor stable
    sel, prev, cursor = select_shadow_updates(sig, prev, cursor, 1)
    assert not np.asarray(sel).any()


def test_select_updates_round_robin_resumes_past_cursor():
    sig = jnp.array([1.0, 2.0, 3.0, 4.0])
    prev = sig.at[1].set(99.0).at[3].set(99.0)  # slots 1 and 3 dirty
    sel, new_sig, cur = select_shadow_updates(sig, prev, jnp.int32(2), 1)
    # round-robin from cursor=2: slot 3 comes before slot 1
    np.testing.assert_array_equal(np.asarray(sel), [False, False, False, True])
    assert int(cur) == 0  # (2 + order(3)=1 + 1) % 4
    sel2, _, _ = select_shadow_updates(sig, new_sig, cur, 1)
    np.testing.assert_array_equal(np.asarray(sel2), [False, True, False, False])


# -- end-to-end through the frame graph --------------------------------------

def test_static_scene_atlas_stable_and_matches_uncached():
    scene = two_light_scene()
    r_cached = make_renderer(scene)
    r_fresh = make_renderer(scene, shadow_cache=False)

    img1 = np.asarray(r_cached.render(cam(0.0))["image"])
    atlas1 = np.asarray(r_cached.state["shadow_cache"][0])
    img1_f = np.asarray(r_fresh.render(cam(0.0))["image"])
    np.testing.assert_allclose(img1, img1_f, atol=1e-6)

    # camera moves; lights + casters static -> atlas bit-identical, image
    # equals the uncached path's (directional LOD is camera-independent)
    img2 = np.asarray(r_cached.render(cam(0.4))["image"])
    atlas2 = np.asarray(r_cached.state["shadow_cache"][0])
    np.testing.assert_array_equal(atlas1, atlas2)
    img2_f = np.asarray(r_fresh.render(cam(0.4))["image"])
    np.testing.assert_allclose(img2, img2_f, atol=1e-6)


def test_moved_light_slot_refreshes_next_frame():
    scene = two_light_scene()
    r = make_renderer(scene)
    r.render(cam())
    atlas1 = np.asarray(r.state["shadow_cache"][0])

    moved = scene._replace(
        lights=scene.lights._replace(
            position=scene.lights.position.at[0].set(
                jnp.array([0.2, -1.0, 0.8])
            )
        )
    )
    r.render(cam(), scene=moved)
    atlas2 = np.asarray(r.state["shadow_cache"][0])
    assert not np.array_equal(atlas1[0], atlas2[0]), "moved light must re-render"
    np.testing.assert_array_equal(atlas1[1], atlas2[1])

    # and the refreshed slot equals a from-scratch render of the moved scene
    r2 = make_renderer(moved)
    r2.render(cam())
    atlas_fresh = np.asarray(r2.state["shadow_cache"][0])
    np.testing.assert_array_equal(atlas2, atlas_fresh)


def test_moved_caster_dirties_slots_that_see_it():
    # both directional frusta are scene-fitted, so both see the box: the
    # per-light signature restriction (ops/shadow.shadow_signature r5)
    # keeps both slots dirty here; band-level locality is exercised by the
    # progressive tests below
    scene = two_light_scene()
    r = make_renderer(scene)
    r.render(cam())
    atlas1 = np.asarray(r.state["shadow_cache"][0])

    inst = scene.instances
    moved = scene._replace(
        instances=inst._replace(
            translation=inst.translation.at[1].set(jnp.array([0.6, 0.8, 0.2]))
        )
    )
    r.render(cam(), scene=moved)
    atlas2 = np.asarray(r.state["shadow_cache"][0])
    assert not np.array_equal(atlas1[0], atlas2[0])
    assert not np.array_equal(atlas1[1], atlas2[1])


def test_budget_staggers_slot_updates():
    scene = two_light_scene()
    r = make_renderer(scene, shadow_update_budget=1)

    r.render(cam())
    atlas1, sig1, cur1 = (np.asarray(x) for x in r.state["shadow_cache"])
    assert (atlas1[0] < 1.0).any(), "slot 0 renders on frame 1"
    np.testing.assert_array_equal(atlas1[1], 1.0)  # slot 1 still initial
    assert np.isnan(sig1[1]).all() and not np.isnan(sig1[0]).any()

    r.render(cam())
    atlas2, sig2, cur2 = (np.asarray(x) for x in r.state["shadow_cache"])
    np.testing.assert_array_equal(atlas1[0], atlas2[0])
    assert (atlas2[1] < 1.0).any(), "slot 1 renders on frame 2"
    assert not np.isnan(sig2).any()

    r.render(cam())
    atlas3 = np.asarray(r.state["shadow_cache"][0])
    np.testing.assert_array_equal(atlas2, atlas3)  # converged


# -- round 5: multi-component signatures + progressive band units ------------

def test_select_updates_multicomponent_sig():
    # (n, C) signatures: dirty = ANY component changed (a single
    # scalar's threshold scales with the whole-scene fold)
    sig = jnp.array([[1.0, 5.0], [2.0, 6.0], [3.0, 7.0]])
    prev = jnp.array([[1.0, 5.0], [2.0, 9.0], [jnp.nan, jnp.nan]])
    sel, new_sig, cur = select_shadow_updates(sig, prev, jnp.int32(0), 0)
    np.testing.assert_array_equal(np.asarray(sel), [False, True, True])
    np.testing.assert_array_equal(np.asarray(new_sig), np.asarray(sig))


def test_band_matrix_tiles_the_full_render():
    """K band renders through band_matrix, stacked, equal the full render
    (same pixel centers; only triangle-setup rounding differs)."""
    from renderer_jax.ops.raster_jax import rasterize
    from renderer_jax.ops.shadow import band_matrix, light_matrices_cube

    scene = two_light_scene()
    from renderer_jax.ops.geometry import (
        coarse_cull, expand_clip_only, prepare_frame_columns,
    )

    prepared = prepare_frame_columns(scene, cam())
    model = prepared[0]
    smin, smax = prepared[5], prepared[6]
    mats = light_matrices_cube(scene.lights, smin, smax)
    m = mats[0, 0]
    S, K = 64, 4
    from renderer_jax.ops.geometry import mats44

    model44 = mats44(model)
    lod = jnp.zeros((model44.shape[0],), jnp.int32)

    def render_under(mat, h):
        clip_mats = jnp.einsum(
            "ij,njk->nik", mat, model44, precision="highest"
        )
        visible = coarse_cull(scene, model44, mat)
        clip, valid, count = expand_clip_only(scene, visible, lod, clip_mats, 512)
        return rasterize(
            clip, valid, S, h, cull_backface=False, count=count
        ).depth

    full = np.asarray(render_under(m, S))
    bands = [
        np.asarray(render_under(band_matrix(m, b, K), S // K)) for b in range(K)
    ]
    tiled = np.concatenate(bands, axis=0)
    # pixel centers coincide; allow triangle-setup rounding on edge pixels
    mismatch = np.abs(tiled - full) > 1e-5
    assert mismatch.mean() < 0.01, f"{mismatch.mean():.4f} of pixels differ"


def _progressive_renderer(scene, K=4, **kw):
    return make_renderer(
        scene, shadow_update_budget=1, shadow_progressive=K, **kw
    )


def test_progressive_converges_to_whole_slot_render():
    scene = two_light_scene()
    K = 4
    r = _progressive_renderer(scene, K=K)
    # budget 1 unit/frame; 2 slots x K bands = 8 units to converge
    for _ in range(2 * K + 1):
        r.render(cam())
    atlas_p, sig_p, _ = (np.asarray(x) for x in r.state["shadow_cache"])
    assert not np.isnan(sig_p).any(), "all units rendered"

    r_whole = make_renderer(scene)
    r_whole.render(cam())
    atlas_w = np.asarray(r_whole.state["shadow_cache"][0])
    mismatch = np.abs(atlas_p - atlas_w) > 1e-5
    assert mismatch.mean() < 0.01, f"{mismatch.mean():.4f} of texels differ"

    # converged: further frames render nothing
    r.render(cam(0.3))
    atlas_p2 = np.asarray(r.state["shadow_cache"][0])
    np.testing.assert_array_equal(atlas_p, atlas_p2)


def test_progressive_moved_caster_dirties_only_overlapping_bands():
    """The progressive-band contract: an instance moving outside a band
    unit's frustum leaves that unit's signature (and atlas rows) alone."""
    scene = two_light_scene()
    K = 4
    r = _progressive_renderer(scene, K=K)
    for _ in range(2 * K + 1):
        r.render(cam())
    atlas1, sig1, _ = (np.asarray(x) for x in r.state["shadow_cache"])

    # nudge the box slightly (stays well inside its band neighborhood)
    inst = scene.instances
    moved = scene._replace(
        instances=inst._replace(
            translation=inst.translation.at[1].set(jnp.array([0.05, 0.8, 0.0]))
        )
    )
    from renderer_jax.ops.geometry import prepare_frame_columns
    from renderer_jax.ops.shadow import light_matrices_cube, shadow_signature

    prepared = prepare_frame_columns(moved, cam())
    mats = light_matrices_cube(moved.lights, prepared[5], prepared[6])
    sig_new = np.asarray(
        shadow_signature(moved, mats, moved.lights, prepared[0], 2,
                         progressive=K)
    )
    changed = (sig_new != sig1).any(axis=-1)  # (2, K) dirty map
    # the 0.5-half-extent box cannot overlap every band of a scene-fitted
    # slot at K=4: at least one band per slot must stay clean, and at
    # least one must be dirty (the box IS in view of both lights)
    for s in range(2):
        assert changed[s].any(), f"slot {s}: box move must dirty some band"
        assert not changed[s].all(), (
            f"slot {s}: box move dirtied every band — per-band restriction lost"
        )
