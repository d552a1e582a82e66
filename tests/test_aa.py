"""Edge-aware AA tier (ops/aa.py): the production anti-aliasing pass.

Reference bar: always-on 4xMSAA + resolve (renderer.rs:1047-1087). The
production tier must (a) leave interior/texture pixels untouched (ID gate),
(b) move geometry-edge pixels toward their across-edge neighbor, and
(c) land measurably closer to the SSAA ground truth than the aliased frame.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from renderer_jax import mathx
from renderer_jax.mathx.camera import Camera
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives


def slanted_scene():
    """A rotated bright box against dark background: long slanted edges."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    box = b.add_mesh(primitives.box())
    m = b.add_material(base_color=(0.95, 0.95, 0.9, 1.0), roughness=0.8)
    c, s = np.cos(0.4), np.sin(0.4)
    b.add_instance(box, m, rotation=(c, 0.0, 0.0, s), scale=1.2)
    b.add_light(position=(2.0, 3.0, 4.0), intensity=25.0)
    return b.build()


def cam():
    return Camera.create(
        position=jnp.array([0.0, 0.3, 3.5]), fov_y=0.8, near=0.1, far=50.0
    )


CFG = PipelineConfig(width=64, height=64, tri_capacity=512, shading="pbr")


def render(scene, **cfg_kw):
    r = Renderer(scene, dataclasses.replace(CFG, **cfg_kw), outputs=("image", "vis"))
    out = r.render(cam())
    return np.asarray(out["image"]), np.asarray(out["vis"].tri_id)


def test_interior_pixels_untouched():
    scene = slanted_scene()
    plain, tri = render(scene)
    aa, _ = render(scene, aa="edge")
    sh = np.pad(tri, 1, mode="edge")
    interior = (
        (tri == sh[:-2, 1:-1]) & (tri == sh[2:, 1:-1])
        & (tri == sh[1:-1, :-2]) & (tri == sh[1:-1, 2:])
    )
    np.testing.assert_array_equal(plain[interior], aa[interior])
    assert not np.array_equal(plain, aa), "edges must change"


def test_edges_move_toward_ssaa_ground_truth():
    scene = slanted_scene()
    plain, _ = render(scene)
    aa, _ = render(scene, aa="edge")
    truth, _ = render(scene, ssaa=4)

    def mse(a):
        return float(np.mean(np.square(np.clip(a, 0, 1) - np.clip(truth, 0, 1))))

    assert mse(aa) < mse(plain), (mse(aa), mse(plain))


def test_aa_composes_with_checkerboard_and_shadows():
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)), translation=(0, 0.8, 0))
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0, shadow_slot=0)
    scene = b.build()

    r = Renderer(
        scene,
        dataclasses.replace(CFG, aa="edge", shade_rate="checkerboard"),
        outputs=("image",),
    )
    r.set_config(shadows=True)
    r.apply_config_now()
    img = np.asarray(r.render(Camera.create(
        position=jnp.array([0.0, 6.0, 0.01]),
        rotation=mathx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2),
        near=0.1, far=50.0,
    ))["image"])
    assert np.isfinite(img).all()
    assert img.max() > 0.1
