"""Plain-JAX (XLA-fused) rasterizer implementing ops/raster_spec.py.

Brute-force but fully vectorized: the image is processed in row strips
(bounded memory); within a strip, triangles stream through in fixed-size
blocks with a running (depth, id, bary) reduction. No binning — every
triangle is tested against every strip. This is the always-correct fallback
and the golden-test mirror of the Pallas tile rasterizer
(ops/raster_pallas.py), which adds binning and register-resident tiles.

Outputs a visibility buffer (depth, tri_id, barycentrics) for deferred
shading — attributes are interpolated later from the soup
(ops/shading.py), so raster bandwidth stays minimal.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from renderer_jax.ops.geometry import adjugate3, pixel_homogeneous
from renderer_jax.ops.raster_spec import DEPTH_CLEAR, FRONT_DET_SIGN, NO_TRIANGLE


class VisibilityBuffer(NamedTuple):
    """Deferred-shading inputs. bary is CHANNEL-FIRST (3, H, W): every
    consumer reads whole (H, W) planes."""

    depth: jnp.ndarray   # (H, W) f32
    tri_id: jnp.ndarray  # (H, W) i32 (NO_TRIANGLE where empty)
    bary: jnp.ndarray    # (3, H, W) f32, perspective-correct normalized


def _edge_accept(lam, adj):
    """Top-left fill rule. lam: (..., 3 edges, P), adj: (..., 3, 3)."""
    a = adj[..., 0:1]
    b = adj[..., 1:2]
    top_left = (a > 0) | ((a == 0) & (b > 0))
    return jnp.all((lam > 0) | ((lam == 0) & top_left), axis=-2)


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "strip_rows", "tri_block", "cull_backface",
        "full_height",
    ),
)
def rasterize(
    clip: jnp.ndarray,
    valid: jnp.ndarray,
    width: int,
    height: int,
    strip_rows: int = 64,
    tri_block: int = 128,
    cull_backface: bool = True,
    count=None,
    y0=0,  # may be traced (shard_map row offset)
    full_height: int = None,
) -> VisibilityBuffer:
    """Rasterize a triangle soup.

    clip: (T, 3, 4) clip-space positions; valid: (T,) bool.
    T must be a multiple of tri_block; height a multiple of strip_rows.
    count: optional traced scalar — when the soup is compacted
    (ops/cull.compact_soup), bounds the triangle loop to ceil(count/block)
    iterations so raster cost scales with visible geometry.
    y0/full_height: render only rows [y0, y0+height) of a full_height-tall
    framebuffer — the hook for sharding the image across devices
    (renderer_jax.parallel).
    """
    t_cap = clip.shape[0]
    tri_block = min(tri_block, t_cap)
    strip_rows = min(strip_rows, height)
    while height % strip_rows:  # fall back to a divisor for odd heights
        strip_rows -= 1
    assert t_cap % tri_block == 0, (t_cap, tri_block)
    n_blocks = t_cap // tri_block
    if count is not None:
        n_blocks_live = jnp.minimum(
            (count + tri_block - 1) // tri_block, n_blocks
        ).astype(jnp.int32)
    else:
        n_blocks_live = n_blocks
    n_strips = height // strip_rows
    p = strip_rows * width

    if full_height is None:
        full_height = height
    u = pixel_homogeneous(clip, width, full_height)  # (T, 3, 3)
    m = jnp.swapaxes(u, -1, -2)
    adj_raw = adjugate3(m)
    det = (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )
    if cull_backface:
        # fixed orientation: back faces get rejected by tri_ok anyway
        adj = adj_raw * FRONT_DET_SIGN
        tri_ok = valid & (det * FRONT_DET_SIGN > 0)
    else:
        adj = adj_raw * jnp.sign(det)[..., None, None]
        tri_ok = valid & (det != 0)
    zs = clip[..., 2]  # (T, 3)
    ws = clip[..., 3]

    # Screen-space bbox per triangle (clamps the near-degenerate f32 coverage
    # band of edge-on slivers; matches the reference's bbox loop). Safe only
    # when all w > 0; near-plane-crossing triangles get the full screen.
    all_front = jnp.all(ws > 1e-9, axis=-1, keepdims=True)
    safe_w = jnp.where(jnp.abs(ws) > 1e-9, ws, 1e-9)
    px = u[..., 0] / safe_w
    py = u[..., 1] / safe_w
    bb_xmin = jnp.where(all_front[..., 0], jnp.min(px, axis=-1) - 0.5, 0.0)
    bb_xmax = jnp.where(all_front[..., 0], jnp.max(px, axis=-1) + 0.5, float(width))
    bb_ymin = jnp.where(all_front[..., 0], jnp.min(py, axis=-1) - 0.5, 0.0)
    bb_ymax = jnp.where(all_front[..., 0], jnp.max(py, axis=-1) + 0.5, float(full_height))

    adj_b = adj.reshape(n_blocks, tri_block, 3, 3)
    zs_b = zs.reshape(n_blocks, tri_block, 3)
    ws_b = ws.reshape(n_blocks, tri_block, 3)
    ok_b = tri_ok.reshape(n_blocks, tri_block)
    bbox_b = jnp.stack([bb_xmin, bb_xmax, bb_ymin, bb_ymax], axis=-1).reshape(
        n_blocks, tri_block, 4
    )

    col = jax.lax.broadcasted_iota(jnp.float32, (strip_rows, width), 1) + 0.5

    def strip_fn(strip_i):
        row = (
            jax.lax.broadcasted_iota(jnp.float32, (strip_rows, width), 0)
            + strip_i.astype(jnp.float32) * strip_rows
            + jnp.asarray(y0, jnp.float32)
            + 0.5
        )
        q = jnp.stack([col.ravel(), row.ravel(), jnp.ones((p,), jnp.float32)], axis=0)  # (3, P)

        def block_fn(b, carry):
            depth, best_id, best_bary = carry
            adj_k = adj_b[b]  # (B, 3, 3)
            lam = jnp.einsum("bij,jp->bip", adj_k, q, precision="highest")  # (B, 3, P)
            covered = _edge_accept(lam, adj_k)  # (B, P)
            bb = bbox_b[b]  # (B, 4)
            covered &= (
                (q[0][None, :] >= bb[:, 0:1])
                & (q[0][None, :] <= bb[:, 1:2])
                & (q[1][None, :] >= bb[:, 2:3])
                & (q[1][None, :] <= bb[:, 3:4])
            )
            w_i = jnp.einsum("bip,bi->bp", lam, ws_b[b], precision="highest")
            z_num = jnp.einsum("bip,bi->bp", lam, zs_b[b], precision="highest")
            covered &= w_i > 0
            z = z_num / jnp.where(w_i != 0, w_i, 1.0)
            covered &= (z >= 0.0) & (z <= 1.0) & ok_b[b][:, None]
            z_masked = jnp.where(covered, z, jnp.inf)
            # winner within block: argmin keeps the lowest local id on ties
            win = jnp.argmin(z_masked, axis=0)  # (P,)
            win_z = jnp.take_along_axis(z_masked, win[None], axis=0)[0]
            win_lam = jnp.take_along_axis(
                lam, win[None, None, :], axis=0
            )[0]  # (3, P)
            closer = win_z < depth
            gid = (b * tri_block + win).astype(jnp.int32)
            depth = jnp.where(closer, win_z, depth)
            best_id = jnp.where(closer, gid, best_id)
            lam_sum = win_lam.sum(axis=0)
            bary = win_lam / jnp.where(lam_sum != 0, lam_sum, 1.0)
            best_bary = jnp.where(closer[None, :], bary, best_bary)
            return depth, best_id, best_bary

        # vz ties the carry to q's axis-varying type so the scan carry
        # typechecks inside shard_map (y0 varies per device)
        vz = q[1, 0] * 0.0
        init = (
            jnp.full((p,), DEPTH_CLEAR, jnp.float32) + vz,
            jnp.full((p,), NO_TRIANGLE, jnp.int32) + vz.astype(jnp.int32),
            jnp.zeros((3, p), jnp.float32) + vz,
        )
        depth, best_id, best_bary = jax.lax.fori_loop(0, n_blocks_live, block_fn, init)
        return (
            depth.reshape(strip_rows, width),
            best_id.reshape(strip_rows, width),
            best_bary.reshape(3, strip_rows, width),
        )

    depth, tri_id, bary = jax.lax.map(strip_fn, jnp.arange(n_strips))
    return VisibilityBuffer(
        depth=depth.reshape(height, width),
        tri_id=tri_id.reshape(height, width),
        bary=jnp.moveaxis(bary, 1, 0).reshape(3, height, width),
    )


def interpolate(vis: VisibilityBuffer, attr: jnp.ndarray, fill=0.0) -> jnp.ndarray:
    """Perspective-correct attribute interpolation from a visibility buffer.

    attr: (T, 3, C) per-triangle-corner attributes -> CHANNEL-FIRST (C, H, W).
    Implemented as 3C gathers of (T,)-vectors at (H, W) indices: every
    intermediate is a well-tiled 2D image plane (a single packed gather would
    carry a (H*W, 3, C) temp with a tiny padded minor dim)."""
    safe = jnp.maximum(vis.tri_id, 0)
    covered = vis.tri_id != NO_TRIANGLE
    c_dim = attr.shape[-1]
    planes = []
    for c in range(c_dim):
        acc = None
        for k in range(3):
            contrib = vis.bary[k] * attr[:, k, c][safe]
            acc = contrib if acc is None else acc + contrib
        planes.append(jnp.where(covered, acc, fill))
    return jnp.stack(planes, axis=0)
