"""Rendered 2D overlay: the realization of the reference's imgui pass.

The reference streams imgui vertex/index soup into mapped buffers and draws
scissored textured quads over the frame with a font atlas
(src/renderer.rs:1799-2263, src/shaders/imgui_pipe.*). Here
the overlay is a fixed-capacity GLYPH/RECT instance table composited onto
the linear framebuffer by a jitted pass: rects are masked alpha blends,
glyphs are dynamic-slice patch blends against a procedural 5x7 font atlas
(the font-atlas-upload analogue, built once on host).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_GLYPHS = 1024
MAX_RECTS = 32
CELL_W, CELL_H = 6, 8  # 5x7 glyph + 1px spacing

# 5x7 bitmap font, 5-bit rows (MSB = leftmost pixel)
_F = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "0": (0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110),
    "1": (0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "2": (0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0b01000, 0b11111),
    "3": (0b11111, 0b00010, 0b00100, 0b00010, 0b00001, 0b10001, 0b01110),
    "4": (0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010),
    "5": (0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110),
    "6": (0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110),
    "7": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000),
    "8": (0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110),
    "9": (0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100),
    "A": (0b01110, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "B": (0b11110, 0b10001, 0b10001, 0b11110, 0b10001, 0b10001, 0b11110),
    "C": (0b01110, 0b10001, 0b10000, 0b10000, 0b10000, 0b10001, 0b01110),
    "D": (0b11100, 0b10010, 0b10001, 0b10001, 0b10001, 0b10010, 0b11100),
    "E": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b11111),
    "F": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000),
    "G": (0b01110, 0b10001, 0b10000, 0b10111, 0b10001, 0b10001, 0b01111),
    "H": (0b10001, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "I": (0b01110, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "J": (0b00111, 0b00010, 0b00010, 0b00010, 0b00010, 0b10010, 0b01100),
    "K": (0b10001, 0b10010, 0b10100, 0b11000, 0b10100, 0b10010, 0b10001),
    "L": (0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b11111),
    "M": (0b10001, 0b11011, 0b10101, 0b10101, 0b10001, 0b10001, 0b10001),
    "N": (0b10001, 0b10001, 0b11001, 0b10101, 0b10011, 0b10001, 0b10001),
    "O": (0b01110, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "P": (0b11110, 0b10001, 0b10001, 0b11110, 0b10000, 0b10000, 0b10000),
    "Q": (0b01110, 0b10001, 0b10001, 0b10001, 0b10101, 0b10010, 0b01101),
    "R": (0b11110, 0b10001, 0b10001, 0b11110, 0b10100, 0b10010, 0b10001),
    "S": (0b01111, 0b10000, 0b10000, 0b01110, 0b00001, 0b00001, 0b11110),
    "T": (0b11111, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100),
    "U": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "V": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01010, 0b00100),
    "W": (0b10001, 0b10001, 0b10001, 0b10101, 0b10101, 0b10101, 0b01010),
    "X": (0b10001, 0b10001, 0b01010, 0b00100, 0b01010, 0b10001, 0b10001),
    "Y": (0b10001, 0b10001, 0b01010, 0b00100, 0b00100, 0b00100, 0b00100),
    "Z": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0b11111),
    ".": (0, 0, 0, 0, 0, 0b00110, 0b00110),
    ",": (0, 0, 0, 0, 0b00110, 0b00100, 0b01000),
    ":": (0, 0b00110, 0b00110, 0, 0b00110, 0b00110, 0),
    ";": (0, 0b00110, 0b00110, 0, 0b00110, 0b00100, 0b01000),
    "-": (0, 0, 0, 0b11111, 0, 0, 0),
    "+": (0, 0b00100, 0b00100, 0b11111, 0b00100, 0b00100, 0),
    "/": (0b00001, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0b10000),
    "%": (0b11000, 0b11001, 0b00010, 0b00100, 0b01000, 0b10011, 0b00011),
    "(": (0b00010, 0b00100, 0b01000, 0b01000, 0b01000, 0b00100, 0b00010),
    ")": (0b01000, 0b00100, 0b00010, 0b00010, 0b00010, 0b00100, 0b01000),
    "=": (0, 0, 0b11111, 0, 0b11111, 0, 0),
    "_": (0, 0, 0, 0, 0, 0, 0b11111),
    "!": (0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0, 0b00100),
    "?": (0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0, 0b00100),
    "<": (0b00010, 0b00100, 0b01000, 0b10000, 0b01000, 0b00100, 0b00010),
    ">": (0b01000, 0b00100, 0b00010, 0b00001, 0b00010, 0b00100, 0b01000),
    "[": (0b01110, 0b01000, 0b01000, 0b01000, 0b01000, 0b01000, 0b01110),
    "]": (0b01110, 0b00010, 0b00010, 0b00010, 0b00010, 0b00010, 0b01110),
    "'": (0b00100, 0b00100, 0b01000, 0, 0, 0, 0),
    '"': (0b01010, 0b01010, 0b10100, 0, 0, 0, 0),
    "#": (0b01010, 0b01010, 0b11111, 0b01010, 0b11111, 0b01010, 0b01010),
    "*": (0, 0b00100, 0b10101, 0b01110, 0b10101, 0b00100, 0),
    "|": (0b00100,) * 7,
}

_CHARS = sorted(_F.keys())
_CHAR_INDEX = {c: i for i, c in enumerate(_CHARS)}


def build_font_atlas() -> np.ndarray:
    """(n_glyphs, CELL_H, CELL_W) f32 coverage atlas (host, built once)."""
    atlas = np.zeros((len(_CHARS), CELL_H, CELL_W), np.float32)
    for i, c in enumerate(_CHARS):
        for r, bits in enumerate(_F[c]):
            for k in range(5):
                if bits & (1 << (4 - k)):
                    atlas[i, r, k] = 1.0
    return atlas


def _glyph_id(ch: str) -> int:
    ch = ch.upper()
    return _CHAR_INDEX.get(ch, _CHAR_INDEX["?"])


class Overlay(NamedTuple):
    """Fixed-capacity overlay instance tables (a small device pytree)."""

    glyph_pos: jnp.ndarray    # (G, 2) i32 top-left pixel (x, y)
    glyph_id: jnp.ndarray     # (G,) i32 font atlas index
    glyph_color: jnp.ndarray  # (G, 4) f32 rgba (linear)
    glyph_count: jnp.ndarray  # () i32
    rect: jnp.ndarray         # (R, 4) f32 x0,y0,x1,y1
    rect_color: jnp.ndarray   # (R, 4) f32 rgba
    rect_count: jnp.ndarray   # () i32

    @staticmethod
    def empty() -> "Overlay":
        return Overlay(
            glyph_pos=jnp.zeros((MAX_GLYPHS, 2), jnp.int32),
            glyph_id=jnp.zeros((MAX_GLYPHS,), jnp.int32),
            glyph_color=jnp.zeros((MAX_GLYPHS, 4), jnp.float32),
            glyph_count=jnp.zeros((), jnp.int32),
            rect=jnp.zeros((MAX_RECTS, 4), jnp.float32),
            rect_color=jnp.zeros((MAX_RECTS, 4), jnp.float32),
            rect_count=jnp.zeros((), jnp.int32),
        )


class OverlayBuilder:
    """Host-side accumulator (the imgui draw-list analogue)."""

    def __init__(self):
        self._glyphs: list = []
        self._rects: list = []

    def rect(self, x0, y0, x1, y1, color=(0.0, 0.0, 0.0), alpha=0.6) -> "OverlayBuilder":
        if len(self._rects) >= MAX_RECTS:
            raise ValueError("overlay rect capacity exceeded")
        self._rects.append((float(x0), float(y0), float(x1), float(y1),
                            (*color, float(alpha))))
        return self

    def text(self, x, y, s: str, color=(1.0, 1.0, 1.0), alpha=1.0) -> "OverlayBuilder":
        """Monospace text; newlines advance CELL_H+2 pixels."""
        cx, cy = int(x), int(y)
        for ch in s:
            if ch == "\n":
                cx, cy = int(x), cy + CELL_H + 2
                continue
            if len(self._glyphs) >= MAX_GLYPHS:
                break  # clip overflowing text rather than raise mid-frame
            if ch != " ":
                self._glyphs.append((cx, cy, _glyph_id(ch), (*color, float(alpha))))
            cx += CELL_W
        return self

    def build(self) -> Overlay:
        o = Overlay.empty()
        g, r = len(self._glyphs), len(self._rects)
        if g:
            pos = np.zeros((MAX_GLYPHS, 2), np.int32)
            gid = np.zeros((MAX_GLYPHS,), np.int32)
            col = np.zeros((MAX_GLYPHS, 4), np.float32)
            for i, (x, y, c, rgba) in enumerate(self._glyphs):
                pos[i] = (x, y)
                gid[i] = c
                col[i] = rgba
            o = o._replace(
                glyph_pos=jnp.asarray(pos), glyph_id=jnp.asarray(gid),
                glyph_color=jnp.asarray(col), glyph_count=jnp.int32(g),
            )
        if r:
            rect = np.zeros((MAX_RECTS, 4), np.float32)
            col = np.zeros((MAX_RECTS, 4), np.float32)
            for i, (x0, y0, x1, y1, rgba) in enumerate(self._rects):
                rect[i] = (x0, y0, x1, y1)
                col[i] = rgba
            o = o._replace(
                rect=jnp.asarray(rect), rect_color=jnp.asarray(col),
                rect_count=jnp.int32(r),
            )
        return o


def compose_overlay(image: jnp.ndarray, overlay: Overlay, font: jnp.ndarray) -> jnp.ndarray:
    """Alpha-blend the overlay onto a linear (H, W, 3) image.

    Rects: masked full-plane blends (<= MAX_RECTS of them). Glyphs: a scan
    of dynamic-slice patch blends (8x8 windows) — the streamed-quad-draw
    analogue, fixed shapes throughout."""
    h, w, _ = image.shape

    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + 0.5
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + 0.5
    r_idx = jnp.arange(MAX_RECTS)

    def rect_body(i, img):
        x0, y0, x1, y1 = (overlay.rect[i, k] for k in range(4))
        inside = (xx >= x0) & (xx < x1) & (yy >= y0) & (yy < y1)
        a = overlay.rect_color[i, 3] * inside.astype(jnp.float32)
        return img * (1 - a[..., None]) + overlay.rect_color[i, :3] * a[..., None]

    image = jax.lax.fori_loop(0, overlay.rect_count, rect_body, image)
    del r_idx

    def glyph_body(i, img):
        x0 = overlay.glyph_pos[i, 0]
        y0g = overlay.glyph_pos[i, 1]
        # CLIP off-screen glyphs (zero alpha) rather than clamp-stacking
        # them at the edge — long HUD lines would otherwise smear dozens of
        # glyphs onto the same border patch
        on = (x0 >= 0) & (x0 <= w - CELL_W) & (y0g >= 0) & (y0g <= h - CELL_H)
        x = jnp.clip(x0, 0, w - CELL_W)
        y = jnp.clip(y0g, 0, h - CELL_H)
        patch = jax.lax.dynamic_slice(img, (y, x, 0), (CELL_H, CELL_W, 3))
        cov = font[overlay.glyph_id[i]]  # (CELL_H, CELL_W)
        a = cov * overlay.glyph_color[i, 3] * on.astype(jnp.float32)
        blended = patch * (1 - a[..., None]) + overlay.glyph_color[i, :3] * a[..., None]
        return jax.lax.dynamic_update_slice(img, blended, (y, x, 0))

    return jax.lax.fori_loop(0, overlay.glyph_count, glyph_body, image)


def hud_overlay(lines: str, width: int) -> Overlay:
    """Standard HUD panel: translucent backdrop + text block at top-left."""
    b = OverlayBuilder()
    rows = lines.split("\n")
    panel_w = min(width - 8, 8 + CELL_W * max((len(r) for r in rows), default=0))
    panel_h = 8 + (CELL_H + 2) * len(rows)
    b.rect(4, 4, 4 + panel_w, 4 + panel_h, color=(0.02, 0.02, 0.03), alpha=0.65)
    b.text(8, 8, lines, color=(0.9, 0.95, 1.0))
    return b.build()
