"""SSAA resolve, checkpoint/resume, HLO dump tests."""

import numpy as np
import jax.numpy as jnp

from renderer_jax.mathx.camera import Camera
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.runtime.checkpoint import load_renderer, save_renderer
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives


def scene():
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material(base_color=(0.9, 0.3, 0.2, 1))
    b.add_instance(box, m)
    b.add_light(position=(2, 3, 4), intensity=20.0)
    return b.build()


def cam():
    return Camera.create(position=jnp.array([0.6, 0.7, 2.5]), near=0.1, far=50.0)


def test_ssaa_output_resolution_and_smoothing():
    s = scene()
    r1 = Renderer(s, PipelineConfig(width=64, height=64, tri_capacity=256, ssaa=1))
    r2 = Renderer(s, PipelineConfig(width=64, height=64, tri_capacity=256, ssaa=2))
    img1 = np.asarray(r1.render(cam())["image"])
    img2 = np.asarray(r2.render(cam())["image"])
    assert img1.shape == img2.shape == (64, 64, 3)
    # SSAA must reduce edge aliasing: fewer pixels exactly equal to the
    # background (edges become blends), and the gradient energy drops
    bg = np.all(np.isclose(img1, [0.05, 0.05, 0.08]), axis=-1)
    bg2 = np.all(np.isclose(img2, [0.05, 0.05, 0.08]), axis=-1)
    assert bg2.sum() < bg.sum()
    g1 = np.abs(np.diff(img1, axis=0)).sum()
    g2 = np.abs(np.diff(img2, axis=0)).sum()
    assert g2 < g1
    # interiors match closely
    interior = ~bg & ~bg2
    assert np.abs(img1 - img2)[interior].mean() < 0.05


def test_checkpoint_roundtrip(tmp_path):
    s = scene()
    cfg = PipelineConfig(width=64, height=64, tri_capacity=256)
    r = Renderer(s, cfg)
    r.set_config(shadows=False, freeze_culling=False)
    out1 = r.render(cam())
    out2 = r.render(cam())
    prefix = str(tmp_path / "ckpt")
    save_renderer(prefix, r)

    r2 = Renderer(scene(), cfg)
    load_renderer(prefix, r2)
    assert r2.frame_number == r.frame_number
    out_resumed = r2.render(cam())
    out_continued = r.render(cam())
    np.testing.assert_allclose(
        np.asarray(out_resumed["image"]), np.asarray(out_continued["image"]), atol=1e-6
    )


def test_hlo_dump(tmp_path):
    from renderer_jax.utils.profiling import dump_hlo

    path = str(tmp_path / "prog.hlo")
    text = dump_hlo(lambda x: x * 2 + 1, jnp.ones((8, 8)), path=path, optimized=False)
    assert "HloModule" in text or "module" in text
    import os

    assert os.path.getsize(path) > 0
