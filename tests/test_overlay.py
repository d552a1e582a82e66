"""Rendered 2D overlay (the imgui-pass parity, ops/overlay.py)."""

import numpy as np
import jax.numpy as jnp

from renderer_jax.ops.overlay import (
    CELL_H,
    CELL_W,
    Overlay,
    OverlayBuilder,
    build_font_atlas,
    compose_overlay,
    hud_overlay,
)


def test_font_atlas_glyph_shapes():
    atlas = build_font_atlas()
    assert atlas.shape[1:] == (CELL_H, CELL_W)
    # 'I' is symmetric; 'A' has a solid crossbar row; '.' only bottom rows
    from renderer_jax.ops.overlay import _CHAR_INDEX

    a = atlas[_CHAR_INDEX["A"]]
    assert a[3, :5].sum() == 5  # crossbar
    dot = atlas[_CHAR_INDEX["."]]
    assert dot[:5].sum() == 0 and dot[5:].sum() > 0


def test_rect_and_text_composite():
    img = jnp.full((64, 96, 3), 0.5, jnp.float32)
    o = (
        OverlayBuilder()
        .rect(8, 8, 88, 40, color=(0.0, 0.0, 0.0), alpha=0.5)
        .text(12, 12, "FPS 60.0", color=(1.0, 1.0, 1.0))
        .build()
    )
    font = jnp.asarray(build_font_atlas())
    out = np.asarray(compose_overlay(img, o, font))
    # backdrop darkened
    assert abs(out[30, 50, 0] - 0.25) < 1e-5
    # outside untouched
    assert abs(out[60, 90, 0] - 0.5) < 1e-5
    # glyph pixels bright: somewhere in the text row there are white pixels
    band = out[12 : 12 + CELL_H, 12 : 12 + 8 * CELL_W]
    assert band.max() > 0.9
    # text is clipped, not crashing, at capacity
    b = OverlayBuilder()
    b.text(0, 0, "X" * 3000)
    assert len(b._glyphs) <= 1024


def test_empty_overlay_is_identity():
    img = jnp.full((16, 32, 3), 0.3, jnp.float32)
    font = jnp.asarray(build_font_atlas())
    out = np.asarray(compose_overlay(img, Overlay.empty(), font))
    np.testing.assert_array_equal(out, np.full((16, 32, 3), 0.3, np.float32))


def test_hud_switch_in_pipeline():
    """hud switch composites the overlay through the frame graph; off keeps
    the image unchanged (present pass identity)."""
    from renderer_jax.mathx.camera import Camera
    from renderer_jax.models import box_scene
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer
    from renderer_jax.scene import SceneLimits

    scene = box_scene(SceneLimits.tiny())
    cfg = PipelineConfig(width=64, height=64, tri_capacity=256)
    r = Renderer(scene, cfg, outputs=("image",))
    cam = Camera.create(position=jnp.array([0.0, 0.5, 3.0]))
    base = np.asarray(r.render(cam)["image"])

    r.set_config(hud=True)
    r.apply_config_now()
    ov = hud_overlay("FPS 12.3\nTRIS 456", 64)
    with_hud = np.asarray(r.render(cam, overlay=ov)["image"])
    assert not np.allclose(base, with_hud)
    # the panel darkens the top-left corner
    assert with_hud[6, 6].mean() < base[6, 6].mean() + 1e-6
    # off again -> identical to base
    r.set_config(hud=False)
    r.apply_config_now()
    again = np.asarray(r.render(cam)["image"])
    np.testing.assert_allclose(again, base, atol=1e-6)
