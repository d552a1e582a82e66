"""glTF writer/loader round-trip tests (the asset pipeline)."""

import numpy as np

from renderer_jax import mathx
from renderer_jax.scene import SceneBuilder, SceneLimits, primitives
from renderer_jax.scene.gltf import load_gltf, write_glb


def test_glb_roundtrip_geometry(tmp_path):
    mesh = primitives.uv_sphere(rings=6, sectors=8)
    path = str(tmp_path / "sphere.glb")
    write_glb(path, [mesh])
    b = load_gltf(path, SceneBuilder(SceneLimits.tiny()))
    assert len(b._meshes) == 1
    got = b._meshes[0]
    np.testing.assert_allclose(got.positions, mesh.positions, atol=1e-6)
    np.testing.assert_array_equal(got.indices, mesh.indices)
    np.testing.assert_allclose(got.normals, mesh.normals, atol=1e-6)
    np.testing.assert_allclose(got.uvs, mesh.uvs, atol=1e-6)


def test_glb_roundtrip_instances_and_materials(tmp_path):
    import jax.numpy as jnp

    box = primitives.box()
    q = np.asarray(mathx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.7))
    path = str(tmp_path / "scene.glb")
    write_glb(
        path,
        [box],
        instances=[(0, 0, (1.0, 2.0, 3.0), tuple(q), 2.0)],
        materials=[dict(base_color=(0.8, 0.1, 0.2, 1.0), metallic=0.3, roughness=0.6)],
    )
    b = load_gltf(path, SceneBuilder(SceneLimits.tiny()))
    assert len(b._instances) == 1
    inst = b._instances[0]
    np.testing.assert_allclose(inst["translation"], [1, 2, 3], atol=1e-5)
    np.testing.assert_allclose(abs(float(np.dot(inst["rotation"], q))), 1.0, atol=1e-5)
    np.testing.assert_allclose(inst["scale"], 2.0, atol=1e-5)
    mat = b._materials[0]
    np.testing.assert_allclose(mat["base_color"], [0.8, 0.1, 0.2, 1.0], atol=1e-6)
    np.testing.assert_allclose(mat["metallic"], 0.3, atol=1e-6)
    np.testing.assert_allclose(mat["roughness"], 0.6, atol=1e-6)


def test_loaded_scene_renders(tmp_path):
    """Full path: procedural -> .glb -> loader -> Renderer -> image."""
    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer

    path = str(tmp_path / "t.glb")
    write_glb(
        path,
        [primitives.box(), primitives.uv_sphere(rings=6, sectors=8)],
        instances=[
            (0, 0, (-0.8, 0, 0), (1, 0, 0, 0), 1.0),
            (1, 1, (0.8, 0, 0), (1, 0, 0, 0), 1.0),
        ],
        materials=[
            dict(base_color=(1, 0, 0, 1)),
            dict(base_color=(0, 0, 1, 1)),
        ],
    )
    b = load_gltf(path, SceneBuilder(SceneLimits.tiny()))
    b.add_light(position=(2, 3, 4), intensity=20.0)
    scene = b.build()
    r = Renderer(scene, PipelineConfig(width=64, height=64, tri_capacity=256))
    img = np.asarray(r.render(Camera.create(position=jnp.array([0.0, 0.5, 3.0])))["image"])
    assert np.isfinite(img).all()
    # red thing on the left, blue thing on the right
    left = img[:, :32].reshape(-1, 3)
    right = img[:, 32:].reshape(-1, 3)
    assert left[:, 0].max() > 0.15 and right[:, 2].max() > 0.15


def test_node_hierarchy_and_matrix(tmp_path):
    """Hand-written glTF JSON with nested nodes and a matrix node."""
    import json, base64, struct

    box = primitives.box()
    pos = box.positions.astype(np.float32)
    idx = box.indices.astype(np.uint32).reshape(-1, 1)
    blob = pos.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [
            {
                "byteLength": len(blob),
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(blob).decode(),
            }
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": idx.nbytes},
        ],
        "accessors": [
            {
                "bufferView": 0, "componentType": 5126, "count": len(pos),
                "type": "VEC3",
                "min": pos.min(0).tolist(), "max": pos.max(0).tolist(),
            },
            {"bufferView": 1, "componentType": 5125, "count": len(idx), "type": "SCALAR"},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1}]}],
        "nodes": [
            {"children": [1], "translation": [5, 0, 0]},
            {
                "mesh": 0,
                # scale by 2 then translate (0, 1, 0), column-major
                "matrix": [2, 0, 0, 0, 0, 2, 0, 0, 0, 0, 2, 0, 0, 1, 0, 1],
            },
        ],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    path = tmp_path / "h.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
    assert len(b._instances) == 1
    inst = b._instances[0]
    np.testing.assert_allclose(inst["translation"], [5, 1, 0], atol=1e-5)
    np.testing.assert_allclose(inst["scale"], 2.0, atol=1e-5)
    # normals were generated for the position-only mesh
    assert np.isfinite(b._meshes[0].normals).all()


def test_skinned_gltf_import(tmp_path):
    """Hand-written glTF with a 2-joint skin + rotation animation: the loaded
    scene's pose must match a manual numpy LBS."""
    import json, base64

    # two-segment bar along +Y, 6 verts, fully weighted to nearest joint
    pos = np.array(
        [[-0.1, 0, 0], [0.1, 0, 0], [-0.1, 1, 0], [0.1, 1, 0], [-0.1, 2, 0], [0.1, 2, 0]],
        np.float32,
    )
    idx = np.array([[0, 1, 2], [1, 3, 2], [2, 3, 4], [3, 5, 4]], np.uint32)
    joints = np.array([[0, 0, 0, 0]] * 2 + [[1, 0, 0, 0]] * 4, np.uint16)
    weights = np.array([[1, 0, 0, 0]] * 6, np.float32)
    # inverse bind: joint0 at origin, joint1 at y=1
    ibm = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ibm[1, 1, 3] = -1.0
    ibm_cols = np.ascontiguousarray(ibm.transpose(0, 2, 1))  # column-major
    # animation: joint1 rotates about Z, 2 keys (0 -> 90deg)
    times = np.array([0.0, 1.0], np.float32)
    rots = np.array([[0, 0, 0, 1], [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]], np.float32)

    blob = b"".join(
        np.ascontiguousarray(a).tobytes()
        for a in (pos, idx, joints, weights, ibm_cols, times, rots)
    )
    offs = np.cumsum([0] + [a.nbytes for a in (pos, idx, joints, weights, ibm_cols, times)])
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64," + base64.b64encode(blob).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": int(o), "byteLength": int(n)}
            for o, n in zip(offs, [pos.nbytes, idx.nbytes, joints.nbytes, weights.nbytes, ibm_cols.nbytes, times.nbytes, rots.nbytes])
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3", "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125, "count": 12, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "VEC4"},
            {"bufferView": 3, "componentType": 5126, "count": 6, "type": "VEC4"},
            {"bufferView": 4, "componentType": 5126, "count": 2, "type": "MAT4"},
            {"bufferView": 5, "componentType": 5126, "count": 2, "type": "SCALAR"},
            {"bufferView": 6, "componentType": 5126, "count": 2, "type": "VEC4"},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "JOINTS_0": 2, "WEIGHTS_0": 3}, "indices": 1}]}],
        "skins": [{"joints": [1, 2], "inverseBindMatrices": 4}],
        "nodes": [
            {"mesh": 0, "skin": 0},
            {"children": [2]},                      # joint0 (root)
            {"translation": [0.0, 1.0, 0.0]},       # joint1
        ],
        "animations": [
            {
                "channels": [{"sampler": 0, "target": {"node": 2, "path": "rotation"}}],
                "samplers": [{"input": 5, "output": 6, "interpolation": "LINEAR"}],
            }
        ],
        "scenes": [{"nodes": [0, 1]}],
        "scene": 0,
    }
    path = tmp_path / "skin.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
    b.add_light(position=(2, 3, 4), intensity=10.0)
    scene = b.build()
    assert int(scene.skins.count) == 1

    from renderer_jax.ops.skin import pose_scene

    # just before t=1 (clips loop at exactly t=duration): joint1 rotated
    # ~90deg about Z around pivot (0,1,0); tip (0.1,2,0) -> pivot + Rz90@(0.1,1,0)
    posed = np.asarray(pose_scene(scene, 0.9999).meshes.positions)
    vsel = np.asarray(scene.skins.vertex_skin) >= 0
    tip = posed[vsel][5]  # vertex (0.1, 2, 0)
    expect = np.array([0.0, 1.0, 0.0]) + np.array([-1.0, 0.1, 0.0])
    np.testing.assert_allclose(tip, expect, atol=5e-3)
    # base vertices (joint0, static) unchanged
    np.testing.assert_allclose(posed[vsel][0], [-0.1, 0, 0], atol=1e-5)


def test_gltf_texture_import(tmp_path):
    """Embedded PNG textures land in the atlas and drive shading."""
    import io, json, base64
    from PIL import Image

    # a 8x8 solid green PNG
    img = np.zeros((8, 8, 4), np.uint8)
    img[..., 1] = 255
    img[..., 3] = 255
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    png_b64 = base64.b64encode(buf.getvalue()).decode()

    box = primitives.box()
    pos = box.positions.astype(np.float32)
    uv = box.uvs.astype(np.float32)
    idx = box.indices.astype(np.uint32).reshape(-1, 1)
    blob = pos.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64," + base64.b64encode(blob).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": uv.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes + uv.nbytes, "byteLength": idx.nbytes},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos), "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": len(uv), "type": "VEC2"},
            {"bufferView": 2, "componentType": 5125, "count": len(idx), "type": "SCALAR"},
        ],
        "images": [{"uri": "data:image/png;base64," + png_b64}],
        "textures": [{"source": 0}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "roughnessFactor": 1.0}}
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2, "material": 0}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    path = tmp_path / "tex.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny(), atlas_size=8))
    assert b._materials[0]["base_color_tex"] >= 0
    b.add_light(position=(2, 3, 4), intensity=25.0)
    scene = b.build()

    import jax.numpy as jnp

    from renderer_jax.mathx.camera import Camera
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer

    r = Renderer(scene, PipelineConfig(width=64, height=64, tri_capacity=256))
    img_out = np.asarray(r.render(Camera.create(position=jnp.array([0.0, 0.4, 2.5])))["image"])
    center = img_out[32, 32]
    assert center[1] > 3 * max(center[0], center[2]), f"expected green, got {center}"


def test_gltf_cubicspline_and_multi_animation_import(tmp_path):
    """A glTF with a CUBICSPLINE translation sampler AND a second animation:
    the import resamples the cubic exactly (matches numpy hermite at key
    times) and registers both clips for runtime selection."""
    import json, base64

    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint32)
    joints = np.array([[0, 0, 0, 0]] * 3, np.uint16)
    weights = np.array([[1, 0, 0, 0]] * 3, np.float32)
    times = np.array([0.0, 1.0], np.float32)
    # CUBICSPLINE translation: (in, value, out) per key
    cs = np.array(
        [
            [[0, 0, 0], [0, 0, 0], [3, 0, 0]],   # key0: value 0, out-tan 3
            [[-1, 0, 0], [1, 0, 0], [0, 0, 0]],  # key1: in-tan -1, value 1
        ],
        np.float32,
    )
    # second animation: LINEAR translation to +y
    lin = np.array([[0, 0, 0], [0, 2, 0]], np.float32)

    arrays = (pos, idx, joints, weights, times, cs, lin)
    blob = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    offs = np.cumsum([0] + [a.nbytes for a in arrays[:-1]])
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64," + base64.b64encode(blob).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": int(o), "byteLength": int(a.nbytes)}
            for o, a in zip(offs, arrays)
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3", "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125, "count": 3, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5123, "count": 3, "type": "VEC4"},
            {"bufferView": 3, "componentType": 5126, "count": 3, "type": "VEC4"},
            {"bufferView": 4, "componentType": 5126, "count": 2, "type": "SCALAR"},
            {"bufferView": 5, "componentType": 5126, "count": 6, "type": "VEC3"},
            {"bufferView": 6, "componentType": 5126, "count": 2, "type": "VEC3"},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "JOINTS_0": 2, "WEIGHTS_0": 3}, "indices": 1}]}],
        "skins": [{"joints": [1]}],
        "nodes": [{"mesh": 0, "skin": 0}, {}],
        "animations": [
            {
                "channels": [{"sampler": 0, "target": {"node": 1, "path": "translation"}}],
                "samplers": [{"input": 4, "output": 5, "interpolation": "CUBICSPLINE"}],
            },
            {
                "channels": [{"sampler": 0, "target": {"node": 1, "path": "translation"}}],
                "samplers": [{"input": 4, "output": 6, "interpolation": "LINEAR"}],
            },
        ],
        "scenes": [{"nodes": [0, 1]}],
        "scene": 0,
    }
    path = tmp_path / "cubic.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
    b.add_light(position=(1, 2, 3), intensity=5.0)
    scene = b.build()
    assert int(scene.skins.count) == 1
    assert int(scene.skins.clip_count[0]) == 2

    from renderer_jax.ops.skin import sample_clips, set_active_clip
    from renderer_jax.scene.types import INTERP_CUBICSPLINE

    # union-time import preserves the CUBICSPLINE mode + tangents, so device
    # playback reproduces the original hermite EXACTLY at ANY time
    assert int(scene.skins.interp[0, 0]) == INTERP_CUBICSPLINE

    def hermite(t):
        dt = 1.0
        f = t
        f2, f3 = f * f, f ** 3
        v0, b0 = cs[0, 1], cs[0, 2]
        v1, a1 = cs[1, 1], cs[1, 0]
        return ((2 * f3 - 3 * f2 + 1) * v0 + dt * (f3 - 2 * f2 + f) * b0
                + (-2 * f3 + 3 * f2) * v1 + dt * (f3 - f2) * a1)

    for t in (0.15, 0.5, 0.83):
        pal = np.asarray(sample_clips(scene.skins, t))[0, 0]
        np.testing.assert_allclose(pal[:3, 3], hermite(t), rtol=1e-4, atol=1e-5)

    # clip 1 (LINEAR +y) selected at runtime
    s2 = set_active_clip(scene, 0, 1)
    pal2 = np.asarray(sample_clips(s2.skins, 0.5))[0, 0]
    np.testing.assert_allclose(pal2[:3, 3], [0, 1, 0], atol=1e-5)


def test_gltf_step_interpolation_exact(tmp_path):
    """A STEP sampler imports with its mode preserved: the snap happens at
    the ORIGINAL key boundary, not smeared by resampling."""
    import json, base64

    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint32)
    joints = np.array([[0, 0, 0, 0]] * 3, np.uint16)
    weights = np.array([[1, 0, 0, 0]] * 3, np.float32)
    times = np.array([0.0, 0.7, 1.0], np.float32)
    vals = np.array([[0, 0, 0], [3, 0, 0], [9, 0, 0]], np.float32)
    arrays = (pos, idx, joints, weights, times, vals)
    blob = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    offs = np.cumsum([0] + [a.nbytes for a in arrays[:-1]])
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64," + base64.b64encode(blob).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": int(o), "byteLength": int(a.nbytes)}
            for o, a in zip(offs, arrays)
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3", "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125, "count": 3, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5123, "count": 3, "type": "VEC4"},
            {"bufferView": 3, "componentType": 5126, "count": 3, "type": "VEC4"},
            {"bufferView": 4, "componentType": 5126, "count": 3, "type": "SCALAR"},
            {"bufferView": 5, "componentType": 5126, "count": 3, "type": "VEC3"},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "JOINTS_0": 2, "WEIGHTS_0": 3}, "indices": 1}]}],
        "skins": [{"joints": [1]}],
        "nodes": [{"mesh": 0, "skin": 0}, {}],
        "animations": [
            {
                "channels": [{"sampler": 0, "target": {"node": 1, "path": "translation"}}],
                "samplers": [{"input": 4, "output": 5, "interpolation": "STEP"}],
            }
        ],
        "scenes": [{"nodes": [0, 1]}],
        "scene": 0,
    }
    path = tmp_path / "step.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
    b.add_light(position=(1, 2, 3), intensity=5.0)
    scene = b.build()

    from renderer_jax.ops.skin import sample_clips
    from renderer_jax.scene.types import INTERP_STEP

    assert int(scene.skins.interp[0, 0]) == INTERP_STEP
    for t, expect in ((0.3, [0, 0, 0]), (0.69, [0, 0, 0]), (0.71, [3, 0, 0]), (0.9, [3, 0, 0])):
        pal = np.asarray(sample_clips(scene.skins, t))[0, 0]
        np.testing.assert_allclose(pal[:3, 3], expect, atol=1e-6)


# -- foreign-file conventions ------------------------------------------------
# The parser had only ever read its own writer's output; these fixtures
# hand-construct files the way OTHER exporters lay them out (ref: the
# reference consumes arbitrary Khronos sample models, gltf_mesh_io.rs).

def _foreign_doc(blob, accessors, buffer_views, mesh_prims):
    import base64

    return {
        "asset": {"version": "2.0"},
        "buffers": [
            {
                "byteLength": len(blob),
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(blob).decode(),
            }
        ],
        "bufferViews": buffer_views,
        "accessors": accessors,
        "meshes": [{"primitives": mesh_prims}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }


def test_interleaved_accessors_with_byte_stride(tmp_path):
    """POSITION+NORMAL interleaved in ONE bufferView (stride 24) — the
    layout most exporters emit for static meshes."""
    import json

    box = primitives.box()
    pos = box.positions.astype(np.float32)
    nrm = box.normals.astype(np.float32)
    inter = np.concatenate([pos, nrm], axis=1)  # (V, 6) rows of 24 B
    idx = box.indices.astype(np.uint32).reshape(-1, 1)
    blob = inter.tobytes() + idx.tobytes()
    doc = _foreign_doc(
        blob,
        accessors=[
            {"bufferView": 0, "byteOffset": 0, "componentType": 5126,
             "count": len(pos), "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
             "count": len(pos), "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
        buffer_views=[
            {"buffer": 0, "byteOffset": 0, "byteLength": inter.nbytes,
             "byteStride": 24},
            {"buffer": 0, "byteOffset": inter.nbytes, "byteLength": idx.nbytes},
        ],
        mesh_prims=[{"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2}],
    )
    path = tmp_path / "interleaved.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
    hm = b._meshes[0]
    np.testing.assert_array_equal(hm.positions, pos)
    np.testing.assert_array_equal(hm.normals, nrm)
    np.testing.assert_array_equal(hm.indices.reshape(-1), idx.reshape(-1))


def test_u8_and_u16_indices(tmp_path):
    """Foreign files index small meshes with u8/u16 (5121/5123)."""
    import json

    box = primitives.box()
    pos = box.positions.astype(np.float32)
    for comp_type, dt in ((5121, np.uint8), (5123, np.uint16)):
        idx = box.indices.astype(dt).reshape(-1, 1)
        blob = pos.tobytes() + idx.tobytes()
        doc = _foreign_doc(
            blob,
            accessors=[
                {"bufferView": 0, "componentType": 5126, "count": len(pos),
                 "type": "VEC3",
                 "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
                {"bufferView": 1, "componentType": comp_type,
                 "count": idx.size, "type": "SCALAR"},
            ],
            buffer_views=[
                {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
                {"buffer": 0, "byteOffset": pos.nbytes,
                 "byteLength": idx.nbytes},
            ],
            mesh_prims=[{"attributes": {"POSITION": 0}, "indices": 1}],
        )
        path = tmp_path / f"idx{comp_type}.gltf"
        path.write_text(json.dumps(doc))
        b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
        np.testing.assert_array_equal(
            b._meshes[0].indices, box.indices.astype(np.int32)
        )


def test_sparse_accessor_substitution(tmp_path):
    """Sparse POSITION accessor: zero base + stored (index, value) pairs
    (the morph-target/displacement layout of the Khronos samples)."""
    import json

    box = primitives.box()
    pos = box.positions.astype(np.float32)
    idx = box.indices.astype(np.uint32).reshape(-1, 1)
    # sparse: displace vertices 2 and 5
    sp_idx = np.asarray([2, 5], np.uint16)
    sp_val = np.asarray([[9.0, 9.0, 9.0], [-9.0, 0.0, 1.0]], np.float32)
    blob = pos.tobytes() + idx.tobytes() + sp_idx.tobytes() + sp_val.tobytes()
    o_idx = pos.nbytes
    o_sidx = o_idx + idx.nbytes
    o_sval = o_sidx + sp_idx.nbytes
    doc = _foreign_doc(
        blob,
        accessors=[
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist(),
             "sparse": {
                 "count": 2,
                 "indices": {"bufferView": 2, "componentType": 5123},
                 "values": {"bufferView": 3},
             }},
            {"bufferView": 1, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
        buffer_views=[
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": o_idx, "byteLength": idx.nbytes},
            {"buffer": 0, "byteOffset": o_sidx, "byteLength": sp_idx.nbytes},
            {"buffer": 0, "byteOffset": o_sval, "byteLength": sp_val.nbytes},
        ],
        mesh_prims=[{"attributes": {"POSITION": 0}, "indices": 1}],
    )
    path = tmp_path / "sparse.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
    want = pos.copy()
    want[[2, 5]] = sp_val
    np.testing.assert_array_equal(b._meshes[0].positions, want)


def test_normalized_u16_uvs(tmp_path):
    """TEXCOORD_0 as normalized u16 (a common exporter compression)."""
    import json

    box = primitives.box()
    pos = box.positions.astype(np.float32)
    uv_f = np.clip(box.uvs.astype(np.float32), 0, 1)
    uv_u16 = np.round(uv_f * 65535.0).astype(np.uint16)
    idx = box.indices.astype(np.uint32).reshape(-1, 1)
    blob = pos.tobytes() + uv_u16.tobytes() + idx.tobytes()
    doc = _foreign_doc(
        blob,
        accessors=[
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5123, "count": len(pos),
             "type": "VEC2", "normalized": True},
            {"bufferView": 2, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
        buffer_views=[
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": uv_u16.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes + uv_u16.nbytes,
             "byteLength": idx.nbytes},
        ],
        mesh_prims=[{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                     "indices": 2}],
    )
    path = tmp_path / "u16uv.gltf"
    path.write_text(json.dumps(doc))
    b = load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
    np.testing.assert_allclose(b._meshes[0].uvs, uv_f, atol=1.0 / 65535.0)


def test_interleaved_overrun_raises(tmp_path):
    """A corrupt stride that runs past the buffer must raise, not wrap."""
    import json

    import pytest

    box = primitives.box()
    pos = box.positions.astype(np.float32)
    blob = pos.tobytes()
    doc = _foreign_doc(
        blob,
        accessors=[
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
        ],
        buffer_views=[
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes,
             "byteStride": 64},  # 24 verts * 64 B >> buffer
        ],
        mesh_prims=[{"attributes": {"POSITION": 0}}],
    )
    path = tmp_path / "overrun.gltf"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="overruns"):
        load_gltf(str(path), SceneBuilder(SceneLimits.tiny()))
