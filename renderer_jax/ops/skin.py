"""Linear-blend skinning + keyframe animation (the CesiumMan capability).

GPU engines skin in the vertex shader from a per-frame joint palette; here a
"pose" pass samples every skin's clip, builds joint palettes (world @
inverse_bind), and rewrites the consolidated vertex pool's positions/normals
— compute-skinning into the vertex buffer, one batched LBS matmul for all
skinned vertices. Downstream passes are oblivious to skinning.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from renderer_jax.mathx.transforms import trs_matrix
from renderer_jax.scene.types import Scene, Skins


def set_active_clip(scene: Scene, skin: int, clip: int) -> Scene:
    """Select which animation clip a skin plays (runtime multi-clip switch;
    returns a new Scene pytree)."""
    skins = scene.skins
    return scene._replace(
        skins=skins._replace(active_clip=skins.active_clip.at[skin].set(clip))
    )


def sample_clips(skins: Skins, time) -> jnp.ndarray:
    """Sample every skin's ACTIVE clip at `time` (looping) -> joint palettes
    (S, J, 4, 4) = world_joint @ inverse_bind.

    Interpolation honors the clip's glTF mode: LINEAR (nlerp for quats),
    STEP, or CUBICSPLINE (hermite with per-key in/out tangents; quaternion
    components are interpolated raw then normalized, per spec)."""
    from renderer_jax.scene.types import INTERP_CUBICSPLINE, INTERP_STEP

    s_cap = skins.key_times.shape[0]
    j_cap = skins.parents.shape[1]
    t = jnp.asarray(time, jnp.float32)

    # active clip selection: slice the (S, C, ...) tables down to (S, ...)
    ci = jnp.clip(skins.active_clip, 0, jnp.maximum(skins.clip_count - 1, 0))

    def sel(arr):  # (S, C, ...) -> (S, ...)
        return jax.vmap(lambda a, i: a[i])(arr, ci)

    times = sel(skins.key_times)      # (S, K)
    counts = sel(skins.key_count)     # (S,)
    durs = sel(skins.duration)        # (S,)
    interp = sel(skins.interp)        # (S,)
    tt = jnp.where(durs > 0, jnp.mod(t, durs), 0.0)  # (S,)

    # keyframe bracket per skin
    def bracket(times_k, tval, count):
        hi = jnp.clip(jnp.searchsorted(times_k, tval, side="right"), 1, jnp.maximum(count - 1, 1))
        lo = hi - 1
        t0 = times_k[lo]
        t1 = times_k[hi]
        dt = t1 - t0
        f = jnp.where(dt > 0, (tval - t0) / dt, 0.0)
        return lo, hi, jnp.clip(f, 0.0, 1.0), jnp.maximum(dt, 0.0)

    lo, hi, f, dt = jax.vmap(bracket)(times, tt, counts)  # (S,)

    def take(arr, idx):  # arr (S, K, ...) -> (S, ...)
        return jax.vmap(lambda a, i: a[i])(arr, idx)

    def interpolate(vals, v_in, v_out, extra_dims):
        """glTF-mode interpolation of (S, C, K, J, ...) tables -> (S, J, ...)."""
        v = sel(vals)
        a_in = sel(v_in)
        b_out = sel(v_out)
        v0, v1 = take(v, lo), take(v, hi)
        b0, a1 = take(b_out, lo), take(a_in, hi)  # out-tan of k0, in-tan of k1
        shape = (s_cap,) + (1,) * extra_dims
        fk = f.reshape(shape)
        dtk = dt.reshape(shape)
        linear = v0 + (v1 - v0) * fk
        f2 = fk * fk
        f3 = f2 * fk
        cubic = (
            (2 * f3 - 3 * f2 + 1) * v0
            + dtk * (f3 - 2 * f2 + fk) * b0
            + (-2 * f3 + 3 * f2) * v1
            + dtk * (f3 - f2) * a1
        )
        mode = interp.reshape(shape)
        out = jnp.where(mode == INTERP_STEP, v0, linear)
        return jnp.where(mode == INTERP_CUBICSPLINE, cubic, out)

    trans = interpolate(skins.key_t, skins.key_t_in, skins.key_t_out, 2)
    scale = interpolate(skins.key_s, skins.key_s_in, skins.key_s_out, 1)

    # quaternions: LINEAR uses hemisphere-corrected nlerp; CUBICSPLINE
    # interpolates raw components (glTF spec) — both then normalize
    r_sel = sel(skins.key_r)
    r0, r1 = take(r_sel, lo), take(r_sel, hi)
    fk = f[:, None, None]
    dot = jnp.sum(r0 * r1, axis=-1, keepdims=True)
    r1h = jnp.where(dot < 0, -r1, r1)
    rot_lin = r0 + (r1h - r0) * fk
    rb0 = take(sel(skins.key_r_out), lo)
    ra1 = take(sel(skins.key_r_in), hi)
    f2 = fk * fk
    f3 = f2 * fk
    dtk = dt[:, None, None]
    rot_cub = (
        (2 * f3 - 3 * f2 + 1) * r0
        + dtk * (f3 - 2 * f2 + fk) * rb0
        + (-2 * f3 + 3 * f2) * r1
        + dtk * (f3 - f2) * ra1
    )
    mode_r = interp[:, None, None]
    rot = jnp.where(mode_r == INTERP_STEP, r0, rot_lin)
    rot = jnp.where(mode_r == INTERP_CUBICSPLINE, rot_cub, rot)
    rot = rot / jnp.maximum(jnp.linalg.norm(rot, axis=-1, keepdims=True), 1e-8)

    local = trs_matrix(trans, rot, scale)  # (S, J, 4, 4)

    # world = parent chain (parents are topologically ordered)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (s_cap, 4, 4))

    def body(j, worlds):
        p = skins.parents[:, j]  # (S,)
        parent_m = jnp.where(
            (p >= 0)[:, None, None],
            jnp.take_along_axis(
                worlds, jnp.clip(p, 0)[:, None, None, None].repeat(4, 2).repeat(4, 3),
                axis=1,
            )[:, 0],
            eye,
        )
        wj = jnp.einsum("sij,sjk->sik", parent_m, local[:, j], precision="highest")
        return worlds.at[:, j].set(wj)

    worlds = jax.lax.fori_loop(
        0, j_cap, body, jnp.broadcast_to(eye[:, None], (s_cap, j_cap, 4, 4))
    )
    return jnp.einsum("sjik,sjkl->sjil", worlds, skins.inverse_bind, precision="highest")


def pose_scene(scene: Scene, time) -> Scene:
    """Return the scene with skinned vertices posed at `time` (LBS on the
    consolidated pool; rigid vertices pass through untouched)."""
    skins = scene.skins
    palettes = sample_clips(skins, time)  # (S, J, 4, 4)
    s_cap, j_cap = palettes.shape[:2]
    flat = palettes.reshape(s_cap * j_cap, 4, 4)

    # per-vertex skin id from weights: rigid vertices have all-zero weights
    wsum = jnp.sum(skins.weights, axis=-1)  # (V,)
    skinned = wsum > 1e-6
    vskin = skins.vertex_skin  # (V,) skin id per vertex, -1 = rigid

    safe_skin = jnp.maximum(vskin, 0)
    jidx = safe_skin[:, None] * j_cap + jnp.clip(skins.joints, 0, j_cap - 1)  # (V, 4)
    mats = flat[jidx]  # (V, 4, 4, 4)
    blend = jnp.einsum("vk,vkij->vij", skins.weights, mats, precision="highest")

    pos = scene.meshes.positions
    h = jnp.concatenate([pos, jnp.ones((pos.shape[0], 1), jnp.float32)], axis=-1)
    posed = jnp.einsum("vij,vj->vi", blend, h, precision="highest")[:, :3]
    nrm = scene.meshes.normals
    posed_n = jnp.einsum("vij,vj->vi", blend[:, :3, :3], nrm, precision="highest")
    posed_n = posed_n / jnp.maximum(jnp.linalg.norm(posed_n, axis=-1, keepdims=True), 1e-8)

    use = (skinned & (vskin >= 0))[:, None]
    new_pos = jnp.where(use, posed, pos)
    new_nrm = jnp.where(use, posed_n, nrm)
    # tri_rec caches REST-pose per-triangle attributes; the posed view must
    # not serve stale rows, so drop it (expansion falls back to the
    # gather-per-corner path for skinned views)
    return scene._replace(
        meshes=scene.meshes._replace(
            positions=new_pos, normals=new_nrm, tri_rec=None, cluster_data=None
        )
    )
