"""Edge-aware morphological anti-aliasing on the visibility buffer.

The reference always renders 4xMSAA and resolves
(src/renderer.rs:1047-1087, 1716). A software rasterizer has no coverage
hardware; SSAA (PipelineConfig.ssaa) reproduces the quality at 4x the
pixel cost of an already pixel-bound frame. This pass is the production
tier: an FXAA-class directional blend that runs ONLY on geometry edges
(triangle-ID discontinuities from the visibility buffer — information MSAA
has to reconstruct from luma), built entirely from shifted whole-image
planes: no gathers.

Per edge pixel: classify the local edge orientation from luma variation,
pick the neighbor across the edge, and blend by FXAA's sub-pixel contrast
weight. Interior texture detail is untouched (the ID gate), so the pass
never blurs what MSAA would keep sharp.
"""

from __future__ import annotations

import jax.numpy as jnp

# rec.709 luma in display space; detection clamps HDR so unclamped
# specular spikes don't saturate the contrast weights
_LW = (0.2126, 0.7152, 0.0722)
EDGE_TAU = 0.0312  # FXAA's low contrast floor
SUBPIX_CAP = 0.75  # FXAA subpix quality


def edge_aa(color: jnp.ndarray, tri_id: jnp.ndarray, halo_axis: str = None):
    """(3, H, W) HDR color -> (3, H, W) anti-aliased.

    tri_id: (H, W) i32 visibility-buffer ids (NO_TRIANGLE background is a
    distinct id, so silhouettes against background count as edges).
    halo_axis: SPMD mesh axis when the image is row-sharded — shard-edge
    neighbor rows are exchanged between devices (ops/pbr._halo_rows) so the
    sharded frame equals the single-device one."""
    from renderer_jax.ops.pbr import _halo_rows

    cl = jnp.clip(color, 0.0, 1.0)
    luma = _LW[0] * cl[0] + _LW[1] * cl[1] + _LW[2] * cl[2]  # (H, W)

    halos = {
        "tri": _halo_rows(tri_id, halo_axis),
        "luma": _halo_rows(luma, halo_axis),
        "col": _halo_rows(color, halo_axis),
    }

    def up(a, key):
        return jnp.concatenate([halos[key][0], a[..., :-1, :]], axis=-2)

    def dn(a, key):
        return jnp.concatenate([a[..., 1:, :], halos[key][1]], axis=-2)

    def left(a, key=None):
        return jnp.concatenate([a[..., :, :1], a[..., :, :-1]], axis=-1)

    def right(a, key=None):
        return jnp.concatenate([a[..., :, 1:], a[..., :, -1:]], axis=-1)

    t_n, t_s = up(tri_id, "tri"), dn(tri_id, "tri")
    t_e, t_w = right(tri_id), left(tri_id)
    id_edge = (
        (tri_id != t_n) | (tri_id != t_s) | (tri_id != t_e) | (tri_id != t_w)
    )

    l_n, l_s = up(luma, "luma"), dn(luma, "luma")
    l_e, l_w = right(luma), left(luma)
    l_max = jnp.maximum(
        luma, jnp.maximum(jnp.maximum(l_n, l_s), jnp.maximum(l_e, l_w))
    )
    l_min = jnp.minimum(
        luma, jnp.minimum(jnp.minimum(l_n, l_s), jnp.minimum(l_e, l_w))
    )
    rng = l_max - l_min
    edge = id_edge & (rng >= EDGE_TAU)

    # orientation: luma varies more across a horizontal edge vertically
    gv = jnp.abs(l_n - luma) + jnp.abs(l_s - luma)
    gh = jnp.abs(l_e - luma) + jnp.abs(l_w - luma)
    horizontal = gv >= gh

    c_n, c_s = up(color, "col"), dn(color, "col")
    c_e, c_w = right(color), left(color)
    pick_n = jnp.abs(l_n - luma) >= jnp.abs(l_s - luma)
    pick_e = jnp.abs(l_e - luma) >= jnp.abs(l_w - luma)
    nb = jnp.where(
        horizontal[None],
        jnp.where(pick_n[None], c_n, c_s),
        jnp.where(pick_e[None], c_e, c_w),
    )

    # FXAA sub-pixel contrast weight: how far the pixel sits from its
    # cross-neighbor average, normalized by the local range
    avg4 = (l_n + l_s + l_e + l_w) * 0.25
    subpix = jnp.clip(jnp.abs(avg4 - luma) / jnp.maximum(rng, 1e-6), 0.0, 1.0)
    w = jnp.where(edge, subpix * subpix * SUBPIX_CAP, 0.0)
    return color + w[None] * (nb - color)
