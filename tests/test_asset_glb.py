"""The committed on-disk asset must render identically to its procedural
twin — the external-asset path the reference exercises at startup
(main.rs:337-351 loads SciFiHelmet.gltf from disk).

assets/colonnade.glb is generated ONCE by scripts/make_asset.py from
models/scenes.colonnade_spec and committed; this test drives the
from-scratch GLB parser (scene/gltf.load_gltf) over the real file."""

import os

import numpy as np
import jax.numpy as jnp

from renderer_jax.mathx.camera import Camera
from renderer_jax.models.scenes import _colonnade_lights, colonnade_scene
from renderer_jax.passes.pipeline import PipelineConfig
from renderer_jax.runtime import Renderer
from renderer_jax.scene import SceneBuilder, SceneLimits
from renderer_jax.scene.gltf import load_gltf

ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "colonnade.glb")


def cam():
    return Camera.create(
        position=jnp.array([0.0, 2.5, 12.0]), fov_y=0.9, near=0.1, far=80.0
    )


def render(scene):
    cfg = PipelineConfig(width=96, height=96, tri_capacity=8192, shading="pbr")
    r = Renderer(scene, cfg, outputs=("image", "vis"))
    out = r.render(cam())
    return np.asarray(out["image"]), np.asarray(out["vis"].tri_id)


def test_committed_glb_exists():
    assert os.path.exists(ASSET), "assets/colonnade.glb must be committed"
    with open(ASSET, "rb") as f:
        assert f.read(4) == b"glTF"


def test_glb_renders_identical_to_procedural_twin():
    b = load_gltf(ASSET, SceneBuilder(SceneLimits()))
    _colonnade_lights(b)
    from_disk = b.build()
    twin = colonnade_scene()

    img_a, tri_a = render(from_disk)
    img_b, tri_b = render(twin)
    assert (tri_a != -1).mean() > 0.2, "scene must cover a good part of the frame"
    np.testing.assert_array_equal(tri_a, tri_b)
    np.testing.assert_allclose(img_a, img_b, atol=1e-6)


def test_glb_through_streaming_loader():
    """The committed asset crosses the ASYNC streaming path: its meshes are
    decoded off-thread (a .glb path source exercises the parser in the
    worker) and uploaded under the per-frame budget into a live scene."""
    import time

    from renderer_jax.models.scenes import colonnade_spec
    from renderer_jax.runtime.streaming import SceneStreamer

    # live base scene with capacity headroom + the colonnade lights
    b = SceneBuilder(SceneLimits())
    _colonnade_lights(b)
    base = b.build()
    streamer = SceneStreamer(base, budget=8)

    # mesh 0 streams straight from the .glb path (worker-thread parse);
    # the rest decode through callables over the same file
    _, instances, _ = colonnade_spec()
    streamer.request_mesh(ASSET, translation=(0.0, -1.0, 0.0))

    def mesh_from_disk(i):
        def decode():
            bb = load_gltf(ASSET, SceneBuilder(SceneLimits()))
            return bb._meshes[i]

        return decode

    for mesh_idx, _mat, t, q, s in instances[1:24]:
        streamer.request_mesh(mesh_from_disk(mesh_idx), translation=t,
                              rotation=q, scale=s)

    deadline = time.time() + 120.0
    scene = base
    while (streamer.stats["uploaded"] < 24) and time.time() < deadline:
        scene = streamer.pump()
        time.sleep(0.01)
    assert streamer.stats["uploaded"] == 24, streamer.stats
    img, tri = render(scene)
    assert (tri != -1).mean() > 0.05
    assert np.isfinite(img).all()
