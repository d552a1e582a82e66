"""Numpy reference rasterizer — the correctness anchor.

Implements ops/raster_spec.py exactly, in float64, with simple per-triangle
bounding-box loops. Slow and obviously-correct; every fast rasterizer
(plain-JAX, Pallas) is golden-tested against this. Plays the role of the
reference's ReferenceRaytrace A/B ground-truth path
(src/renderer/systems/reference_raytracer.rs) but for the
whole raster pipeline.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from renderer_jax.ops.raster_spec import DEPTH_CLEAR, FRONT_DET_SIGN, NO_TRIANGLE


class RasterOutput(NamedTuple):
    depth: np.ndarray   # (H, W) f32, DEPTH_CLEAR where empty
    tri_id: np.ndarray  # (H, W) i32, NO_TRIANGLE where empty
    bary: np.ndarray    # (H, W, 3) f32, perspective-correct normalized


def pixel_homogeneous(clip: np.ndarray, width: int, height: int) -> np.ndarray:
    """Clip (N,4) -> pixel-homogeneous (N,3): (px*w, py*w, w). Pure linear map."""
    x, y, _, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    return np.stack(
        [(x + w) * (0.5 * width), (w - y) * (0.5 * height), w], axis=-1
    )


def _adjugate3(m: np.ndarray) -> np.ndarray:
    """Adjugate of a 3x3 matrix (adj(M) @ M = det(M) I)."""
    a = np.empty_like(m)
    a[0, 0] = m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
    a[0, 1] = m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]
    a[0, 2] = m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]
    a[1, 0] = m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]
    a[1, 1] = m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]
    a[1, 2] = m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]
    a[2, 0] = m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]
    a[2, 1] = m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]
    a[2, 2] = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    return a


def _edge_accept(lam: np.ndarray, coeff: np.ndarray) -> np.ndarray:
    """Top-left fill rule. lam: (3, P) edge values; coeff: (3, 3) rows (a,b,c).
    Accept where lam > 0, or lam == 0 and the edge is top-left."""
    a = coeff[:, 0:1]
    b = coeff[:, 1:2]
    top_left = (a > 0) | ((a == 0) & (b > 0))
    return np.all((lam > 0) | ((lam == 0) & top_left), axis=0)


def rasterize_ref(
    clip: np.ndarray,
    tris: np.ndarray,
    width: int,
    height: int,
    cull_backface: bool = True,
    tri_valid: Optional[np.ndarray] = None,
) -> RasterOutput:
    """Rasterize triangles given clip-space vertex positions.

    clip: (V, 4) float; tris: (T, 3) int vertex indices;
    tri_valid: optional (T,) bool mask.
    """
    clip = np.asarray(clip, np.float64)
    tris = np.asarray(tris, np.int64)
    depth = np.full((height, width), DEPTH_CLEAR, np.float64)
    tri_id = np.full((height, width), NO_TRIANGLE, np.int32)
    bary = np.zeros((height, width, 3), np.float64)

    u_all = pixel_homogeneous(clip, width, height)  # (V, 3)

    for t in range(len(tris)):
        if tri_valid is not None and not tri_valid[t]:
            continue
        vi = tris[t]
        u = u_all[vi]  # (3 verts, 3)
        m = u.T  # columns are vertices
        det = np.linalg.det(m)
        if det == 0.0:
            continue
        facing = np.sign(det) * FRONT_DET_SIGN  # +1 front, -1 back
        if cull_backface and facing < 0:
            continue
        # orient so that inside => lam >= 0
        adj = _adjugate3(m) * np.sign(det)

        w = clip[vi, 3]
        z = clip[vi, 2]

        # bounding box (only safe when the tri is fully in front of the camera)
        if np.all(w > 1e-9):
            px = u[:, 0] / w
            py = u[:, 1] / w
            x0 = max(int(np.floor(px.min() - 0.5)), 0)
            x1 = min(int(np.ceil(px.max() + 0.5)), width)
            y0 = max(int(np.floor(py.min() - 0.5)), 0)
            y1 = min(int(np.ceil(py.max() + 0.5)), height)
            if x0 >= x1 or y0 >= y1:
                continue
        else:
            x0, x1, y0, y1 = 0, width, 0, height

        ys, xs = np.mgrid[y0:y1, x0:x1]
        q = np.stack(
            [xs.ravel() + 0.5, ys.ravel() + 0.5, np.ones(xs.size)], axis=0
        )  # (3, P)
        lam = adj @ q  # (3, P)
        covered = _edge_accept(lam, adj)

        w_interp = lam.T @ w  # (P,)
        covered &= w_interp > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            z_ndc = (lam.T @ z) / w_interp
        covered &= (z_ndc >= 0.0) & (z_ndc <= 1.0)
        if not covered.any():
            continue

        rows = ys.ravel()[covered]
        cols = xs.ravel()[covered]
        zc = z_ndc[covered]
        closer = zc < depth[rows, cols]
        rows, cols, zc = rows[closer], cols[closer], zc[closer]
        if rows.size == 0:
            continue
        depth[rows, cols] = zc
        tri_id[rows, cols] = t
        lam_c = lam[:, covered][:, closer]
        bary[rows, cols] = (lam_c / lam_c.sum(axis=0, keepdims=True)).T

    return RasterOutput(
        depth=depth.astype(np.float32), tri_id=tri_id, bary=bary.astype(np.float32)
    )


def interpolate(
    out: RasterOutput, tris: np.ndarray, attrs: np.ndarray, fill=0.0
) -> np.ndarray:
    """Perspective-correct per-pixel attribute interpolation from a
    visibility buffer. attrs: (V, C) -> (H, W, C)."""
    tris = np.asarray(tris, np.int64)
    attrs = np.asarray(attrs, np.float64)
    h, w = out.tri_id.shape
    safe_id = np.maximum(out.tri_id, 0)
    corner = attrs[tris[safe_id]]  # (H, W, 3, C)
    img = np.einsum("hwk,hwkc->hwc", out.bary.astype(np.float64), corner)
    img = np.where((out.tri_id != NO_TRIANGLE)[..., None], img, fill)
    return img.astype(np.float32)
