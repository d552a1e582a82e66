"""Two-pass occlusion-culling tests."""

import numpy as np
import jax.numpy as jnp

from renderer_jax.mathx.camera import Camera
from renderer_jax.ops.occlusion import build_depth_pyramid
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives


def test_depth_pyramid_max_reduction():
    d = np.full((16, 16), 0.2, np.float32)
    d[4, 4] = 0.9  # one far texel
    pyr = build_depth_pyramid(jnp.asarray(d), 3)
    assert pyr[0].shape == (8, 8) and pyr[2].shape == (2, 2)
    assert float(pyr[0][2, 2]) == np.float32(0.9)  # max survives
    assert float(pyr[2][0, 0]) == np.float32(0.9)
    assert float(pyr[2][1, 1]) == np.float32(0.2)


def occluder_scene():
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material()
    # big wall right in front of the camera...
    b.add_instance(box, m, translation=(0.0, 0.0, 1.0), scale=4.0)
    # ...hiding a small box behind it
    b.add_instance(box, m, translation=(0.0, 0.0, -3.0), scale=0.5)
    b.add_light(position=(2, 3, 4), intensity=20.0)
    return b.build()


def run_frames(occlusion, frames=3):
    scene = occluder_scene()
    cfg = PipelineConfig(width=64, height=64, tri_capacity=512)
    r = Renderer(scene, cfg, outputs=("image", "vis", "soup"))
    r.set_config(occlusion_culling=occlusion)
    r.apply_config_now()
    cam = Camera.create(position=jnp.array([0.0, 0.0, 5.0]), near=0.1, far=50.0)
    out = None
    for _ in range(frames):
        out = r.render(cam)
    return out


def test_occluded_instance_culled():
    out_on = run_frames(True)
    out_off = run_frames(False)
    # without occlusion culling: both boxes' triangles survive (24 tris pre-
    # backface, ~12+ post); with it: only the wall (hidden box culled)
    n_on = int(out_on["soup"].count)
    n_off = int(out_off["soup"].count)
    assert n_off > n_on, (n_off, n_on)
    assert n_on <= 12  # just the wall's front faces + margins
    # the image is identical either way (the culled box was invisible)
    np.testing.assert_allclose(
        np.asarray(out_on["image"]), np.asarray(out_off["image"]), atol=1e-6
    )


def test_visible_instance_never_culled():
    """Conservative: an object IN FRONT of the wall must survive."""
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material()
    b.add_instance(box, m, translation=(0.0, 0.0, 1.0), scale=4.0)  # wall
    b.add_instance(box, m, translation=(0.0, 0.0, 3.5), scale=0.3)  # in front
    b.add_light(position=(2, 3, 4), intensity=20.0)
    scene = b.build()
    cfg = PipelineConfig(width=64, height=64, tri_capacity=512)
    r = Renderer(scene, cfg, outputs=("image", "vis", "soup"))
    r.set_config(occlusion_culling=True)
    r.apply_config_now()
    cam = Camera.create(position=jnp.array([0.0, 0.0, 5.0]), near=0.1, far=50.0)
    for _ in range(3):
        out = r.render(cam)
    # front box visible: its 2 front triangles join the wall's 2 (the
    # head-on view leaves side faces edge-on/backfacing)
    assert int(out["soup"].count) > 2
    # center of image shows the small front box (closer depth than wall)
    d = np.asarray(out["vis"].depth)
    assert d[32, 32] < d[4, 4]


def test_large_partially_visible_instance_never_culled():
    """Soundness regression: a screen-filling box whose bbox clamps to the
    pyramid's top level must not be culled against a corner sample of its
    own depth (the bug oscillated the city scene's visible set
    140k -> 2 -> 128k across frames)."""
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material()
    # one big box dominating the view; nothing occludes it
    b.add_instance(box, m, translation=(0.0, 0.0, 0.0), scale=6.0)
    b.add_light(position=(2, 3, 4), intensity=20.0)
    scene = b.build()

    cfg = PipelineConfig(width=128, height=128, tri_capacity=512)
    r = Renderer(scene, cfg, outputs=("soup",))
    r.set_config(occlusion_culling=True)
    r.apply_config_now()
    cam = Camera.create(
        position=jnp.array([0.0, 0.5, 6.0]), fov_y=0.9, near=0.1, far=60.0
    )
    counts = []
    for k in range(4):
        # slight orbit so prev-frame depth is the box's own surface
        c = Camera.create(
            position=jnp.array([0.15 * k, 0.5, 6.0]), fov_y=0.9,
            near=0.1, far=60.0,
        )
        counts.append(int(np.asarray(r.render(c)["soup"].count)))
    assert min(counts[1:]) > 0.8 * counts[0], counts
