"""Fixed-capacity SoA scene pytrees.

Capacity-and-mask design: XLA programs want static shapes, so every array
here is allocated at a fixed capacity with a used-count/alive-mask — exactly
the reference's own design (2400 indirect draw slots, 3M consolidated
vertices, 4096 model matrices: src/renderer.rs:174-185,
src/shaders/generate_work.comp:36-50). Dead slots are masked out inside the
kernels rather than compacted on the host.

Everything is a NamedTuple => automatically a JAX pytree; the whole Scene can
be passed through jit / donated / sharded.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class SceneLimits(NamedTuple):
    """Design envelope, mirroring the reference's constants (BASELINE.md)."""

    max_vertices: int = 1 << 20      # consolidated vertex capacity (ref: 3M)
    # library triangle capacity (instancing multiplies at draw time; the
    # reference consolidates ~1M tris of UNIQUE meshes, renderer.rs:174-181).
    # The default stays within TRI_REC_MAX_BYTES so the wide per-triangle
    # record table (the fast expansion path) exists: its padded rows cost
    # 512 B per SLOT (128 MB at this default), so pass tighter limits for
    # small scenes and bigger ones for huge imports (tri_rec auto-disables
    # above the budget and expansion falls back to per-corner gathers).
    max_triangles: int = 1 << 18
    max_meshes: int = 256            # distinct meshes in the library
    max_instances: int = 16384       # ref: 4096 model matrices
    max_materials: int = 256
    max_lights: int = 16             # ref: 16 shadow atlas slots
    max_textures: int = 64           # ref: 2x3072 bindless (atlas layers here)
    max_skins: int = 4               # skinned meshes (CesiumMan config)
    max_joints: int = 32             # joints per skin
    max_keyframes: int = 64          # animation keys per clip
    max_clips: int = 4               # animation clips per skin

    @staticmethod
    def tiny() -> "SceneLimits":
        """Small limits for unit tests / dryruns."""
        return SceneLimits(
            max_vertices=4096,
            max_triangles=4096,
            max_meshes=16,
            max_instances=64,
            max_materials=16,
            max_lights=4,
            max_textures=4,
            max_skins=2,
            max_joints=8,
            max_keyframes=16,
            max_clips=2,
        )


# tri_rec column layout
TR_POS = 0
TR_NRM = 9
TR_UV = 18
TR_TAN = 24
TR_COLS = 36
TRI_REC_MAX_BYTES = 1 << 28  # 256 MB (512 B padded row per triangle slot)

# triangle clusters (meshlet analogue): every (mesh, LOD) index range is
# padded to a CLUSTER multiple so cluster c covers library triangles
# [32c, 32c+32); cluster_data rows hold the object-space bounding sphere +
# normal cone used for cluster-level frustum/backface culling before
# draw-stream expansion (ref: per-mesh dispatch granularity of the cull
# compute pass; meshopt-style cone culling)
CLUSTER = 32
CL_CENTER = 0   # 0..2 bounding-sphere center (object space)
CL_RADIUS = 3
CL_AXIS = 4     # 4..6 normal-cone axis (unit)
CL_COS = 7      # cone half-angle cos
CL_SIN = 8      # cone half-angle sin (> 1 disables backface culling)
# real (non-padding) triangles in the cluster, always a prefix. Pad slots
# are masked STRUCTURALLY with this count: relying on their degenerate
# det == 0 breaks under XLA's FMA contraction (x*y - y*x leaves a ~1-ulp
# residual when fused), which once let pads rasterize garbage.
CL_COUNT = 9
CL_COLS = 12


class MeshLibrary(NamedTuple):
    """Consolidated mesh megabuffers + per-mesh directory.

    The analogue of the reference's ConsolidatedMeshBuffers
    (consolidate_mesh_buffers.rs): all meshes share one positions / attributes
    / index pool so culling and rasterization read from a single binding.
    Indices are *library-global* (already offset by the mesh's vertex base).

    Per-mesh LOD directory: ``lod_index_offset[m, l]`` / ``lod_tri_count[m, l]``
    give up to MAX_LODS index ranges per mesh (ref: <=6 LODs,
    scene_loader.rs:739-756). LOD 0 is the full mesh.
    """

    MAX_LODS = 6

    positions: jnp.ndarray     # (V, 3) f32
    normals: jnp.ndarray       # (V, 3) f32
    tangents: jnp.ndarray      # (V, 4) f32 (xyz + handedness w)
    uvs: jnp.ndarray           # (V, 2) f32
    indices: jnp.ndarray       # (T, 3) i32, library-global vertex ids
    vertex_count: jnp.ndarray  # () i32, used vertices
    tri_count: jnp.ndarray     # () i32, used triangles
    mesh_count: jnp.ndarray    # () i32
    # per-mesh directory
    mesh_vertex_offset: jnp.ndarray  # (M,) i32
    mesh_vertex_count: jnp.ndarray   # (M,) i32
    lod_index_offset: jnp.ndarray    # (M, MAX_LODS) i32, in triangles
    lod_tri_count: jnp.ndarray       # (M, MAX_LODS) i32
    mesh_aabb_min: jnp.ndarray       # (M, 3) f32, object space
    mesh_aabb_max: jnp.ndarray       # (M, 3) f32
    # (T, 36) f32 per-TRIANGLE packed corner attributes
    # [pos c0..c2 (9) | nrm (9) | uv (6) | tan xyzw (12)] — one wide row
    # gather replaces 4+ narrow vertex gathers in draw-stream expansion
    # (gathers are index-rate-bound). None when the
    # capacity would exceed TRI_REC_MAX_BYTES (rows pad to 512 B physical).
    # Invalidated (None) by the pose pass for skinned scene views.
    tri_rec: jnp.ndarray = None
    # (T // CLUSTER, CL_COLS) f32 per-cluster sphere + normal cone (see
    # CL_* constants); present iff tri_rec is (same gating/invalidations)
    cluster_data: jnp.ndarray = None

    @staticmethod
    def empty(limits: SceneLimits) -> "MeshLibrary":
        V, T, M = limits.max_vertices, limits.max_triangles, limits.max_meshes
        L = MeshLibrary.MAX_LODS
        f32, i32 = jnp.float32, jnp.int32
        return MeshLibrary(
            positions=jnp.zeros((V, 3), f32),
            normals=jnp.zeros((V, 3), f32),
            tangents=jnp.zeros((V, 4), f32),
            uvs=jnp.zeros((V, 2), f32),
            indices=jnp.zeros((T, 3), i32),
            vertex_count=jnp.zeros((), i32),
            tri_count=jnp.zeros((), i32),
            mesh_count=jnp.zeros((), i32),
            mesh_vertex_offset=jnp.zeros((M,), i32),
            mesh_vertex_count=jnp.zeros((M,), i32),
            lod_index_offset=jnp.zeros((M, L), i32),
            lod_tri_count=jnp.zeros((M, L), i32),
            mesh_aabb_min=jnp.zeros((M, 3), f32),
            mesh_aabb_max=jnp.zeros((M, 3), f32),
            tri_rec=(
                jnp.zeros((T, TR_COLS), f32)
                if T * 512 <= TRI_REC_MAX_BYTES
                else None
            ),
            cluster_data=(
                jnp.zeros((T // CLUSTER, CL_COLS), f32)
                if T * 512 <= TRI_REC_MAX_BYTES
                else None
            ),
        )


class Instances(NamedTuple):
    """Per-entity SoA: the ECS columns the render path consumes.

    Mirrors Position/Rotation/Scale/GltfMesh/DrawIndex components
    (src/ecs/components.rs, renderer.rs:117-149). ``alive``
    replaces entity despawn (the ``Deleting`` marker) — dead slots stay
    allocated and masked.
    """

    translation: jnp.ndarray  # (N, 3) f32
    rotation: jnp.ndarray     # (N, 4) f32 quat (w,x,y,z)
    scale: jnp.ndarray        # (N,) f32 uniform scale
    mesh_id: jnp.ndarray      # (N,) i32
    material_id: jnp.ndarray  # (N,) i32
    alive: jnp.ndarray        # (N,) bool
    count: jnp.ndarray        # () i32, slots in use (alive or dead)

    @staticmethod
    def empty(limits: SceneLimits) -> "Instances":
        N = limits.max_instances
        return Instances(
            translation=jnp.zeros((N, 3), jnp.float32),
            rotation=jnp.tile(jnp.array([1.0, 0, 0, 0], jnp.float32), (N, 1)),
            scale=jnp.ones((N,), jnp.float32),
            mesh_id=jnp.zeros((N,), jnp.int32),
            material_id=jnp.zeros((N,), jnp.int32),
            alive=jnp.zeros((N,), bool),
            count=jnp.zeros((), jnp.int32),
        )


class Materials(NamedTuple):
    """PBR metallic-roughness material table (glTF semantics; matches the
    parameters consumed by the reference's gltf_mesh.frag)."""

    base_color_factor: jnp.ndarray  # (K, 4) f32
    metallic: jnp.ndarray           # (K,) f32
    roughness: jnp.ndarray          # (K,) f32
    emissive: jnp.ndarray           # (K, 3) f32
    base_color_tex: jnp.ndarray     # (K,) i32, atlas layer or -1
    normal_tex: jnp.ndarray         # (K,) i32, atlas layer or -1
    count: jnp.ndarray              # () i32

    @staticmethod
    def empty(limits: SceneLimits) -> "Materials":
        K = limits.max_materials
        return Materials(
            base_color_factor=jnp.ones((K, 4), jnp.float32),
            metallic=jnp.zeros((K,), jnp.float32),
            roughness=jnp.full((K,), 0.8, jnp.float32),
            emissive=jnp.zeros((K, 3), jnp.float32),
            base_color_tex=jnp.full((K,), -1, jnp.int32),
            normal_tex=jnp.full((K,), -1, jnp.int32),
            count=jnp.zeros((), jnp.int32),
        )


class Lights(NamedTuple):
    """Point/directional lights with shadow-atlas slots (ref: 4x4 atlas of
    4096^2, shadow_mapping.rs:22-24; light components main.rs:365-384)."""

    position: jnp.ndarray   # (L, 3) f32 (direction for directional lights)
    color: jnp.ndarray      # (L, 3) f32, linear radiance scale
    intensity: jnp.ndarray  # (L,) f32
    directional: jnp.ndarray  # (L,) bool
    shadow_slot: jnp.ndarray  # (L,) i32, atlas slot or -1
    alive: jnp.ndarray      # (L,) bool
    count: jnp.ndarray      # () i32

    @staticmethod
    def empty(limits: SceneLimits) -> "Lights":
        L = limits.max_lights
        return Lights(
            position=jnp.zeros((L, 3), jnp.float32),
            color=jnp.ones((L, 3), jnp.float32),
            intensity=jnp.ones((L,), jnp.float32),
            directional=jnp.zeros((L,), bool),
            shadow_slot=jnp.full((L,), -1, jnp.int32),
            alive=jnp.zeros((L,), bool),
            count=jnp.zeros((), jnp.int32),
        )


# clip interpolation modes (glTF animation.sampler.interpolation)
INTERP_LINEAR = 0
INTERP_STEP = 1
INTERP_CUBICSPLINE = 2


class Skins(NamedTuple):
    """Skinning + animation data (the CesiumMan capability).

    Vertex skin attributes live parallel to the consolidated vertex pool
    (zero weights = rigid vertex). Each skin has a joint hierarchy (parents
    topologically ordered: parent index < child index), inverse bind
    matrices, and up to max_clips TRS keyframe clips selected at runtime by
    active_clip. Interpolation per clip: LINEAR, STEP, or CUBICSPLINE
    (glTF cubic hermite with per-key in/out tangents; *_in/*_out tables are
    only meaningful for cubic clips).
    """

    joints: jnp.ndarray        # (V, 4) i32 joint ids per vertex (skin-local)
    weights: jnp.ndarray       # (V, 4) f32
    vertex_skin: jnp.ndarray   # (V,) i32 owning skin, -1 = rigid
    parents: jnp.ndarray       # (S, J) i32, -1 = root
    inverse_bind: jnp.ndarray  # (S, J, 4, 4) f32
    joint_count: jnp.ndarray   # (S,) i32
    # clip keyframes: translation/rotation/scale per joint, per clip
    key_times: jnp.ndarray     # (S, C, K) f32 (padded with last time)
    key_t: jnp.ndarray         # (S, C, K, J, 3) f32
    key_t_in: jnp.ndarray      # (S, C, K, J, 3) f32 cubic in-tangents
    key_t_out: jnp.ndarray     # (S, C, K, J, 3) f32 cubic out-tangents
    key_r: jnp.ndarray         # (S, C, K, J, 4) f32 quat (w,x,y,z)
    key_r_in: jnp.ndarray      # (S, C, K, J, 4) f32
    key_r_out: jnp.ndarray     # (S, C, K, J, 4) f32
    key_s: jnp.ndarray         # (S, C, K, J) f32
    key_s_in: jnp.ndarray      # (S, C, K, J) f32
    key_s_out: jnp.ndarray     # (S, C, K, J) f32
    key_count: jnp.ndarray     # (S, C) i32
    duration: jnp.ndarray      # (S, C) f32
    interp: jnp.ndarray        # (S, C) i32 INTERP_* mode
    clip_count: jnp.ndarray    # (S,) i32
    active_clip: jnp.ndarray   # (S,) i32 runtime clip selection
    # per-mesh skin binding: -1 = rigid mesh
    mesh_skin: jnp.ndarray     # (M,) i32
    count: jnp.ndarray         # () i32

    @staticmethod
    def empty(limits: SceneLimits) -> "Skins":
        V, S, C, J, K, M = (
            limits.max_vertices, limits.max_skins, limits.max_clips,
            limits.max_joints, limits.max_keyframes, limits.max_meshes,
        )
        f32, i32 = jnp.float32, jnp.int32
        return Skins(
            joints=jnp.zeros((V, 4), i32),
            weights=jnp.zeros((V, 4), f32),
            vertex_skin=jnp.full((V,), -1, i32),
            parents=jnp.full((S, J), -1, i32),
            inverse_bind=jnp.tile(jnp.eye(4, dtype=f32), (S, J, 1, 1)),
            joint_count=jnp.zeros((S,), i32),
            key_times=jnp.zeros((S, C, K), f32),
            key_t=jnp.zeros((S, C, K, J, 3), f32),
            key_t_in=jnp.zeros((S, C, K, J, 3), f32),
            key_t_out=jnp.zeros((S, C, K, J, 3), f32),
            key_r=jnp.tile(jnp.array([1, 0, 0, 0], f32), (S, C, K, J, 1)),
            key_r_in=jnp.zeros((S, C, K, J, 4), f32),
            key_r_out=jnp.zeros((S, C, K, J, 4), f32),
            key_s=jnp.ones((S, C, K, J), f32),
            key_s_in=jnp.zeros((S, C, K, J), f32),
            key_s_out=jnp.zeros((S, C, K, J), f32),
            key_count=jnp.zeros((S, C), i32),
            duration=jnp.ones((S, C), f32),
            interp=jnp.zeros((S, C), i32),
            clip_count=jnp.zeros((S,), i32),
            active_clip=jnp.zeros((S,), i32),
            mesh_skin=jnp.full((M,), -1, i32),
            count=jnp.zeros((), i32),
        )


class Scene(NamedTuple):
    """The whole renderable world as one pytree."""

    meshes: MeshLibrary
    instances: Instances
    materials: Materials
    lights: Lights
    atlas: "TextureAtlas"  # packed mip pyramid (scene/textures.py)
    skins: Skins

    @staticmethod
    def empty(limits: SceneLimits) -> "Scene":
        from renderer_jax.scene.textures import empty_atlas

        return Scene(
            meshes=MeshLibrary.empty(limits),
            instances=Instances.empty(limits),
            materials=Materials.empty(limits),
            lights=Lights.empty(limits),
            atlas=empty_atlas(),
            skins=Skins.empty(limits),
        )


def as_numpy_scene(scene: Scene) -> Scene:
    """Pull a scene to host numpy (for the reference rasterizer / debugging)."""
    import jax

    return jax.tree_util.tree_map(np.asarray, scene)
