"""Host-side scene builder: accumulates meshes/instances/materials in numpy,
then freezes into the fixed-capacity device Scene pytree.

This is the synchronous load path of the reference (gltf_mesh_io.rs load_gltf
+ consolidate_mesh_buffers.rs) — meshes are consolidated into megabuffers at
build time with library-global indices; instances reference meshes by id.
The async streaming path lives in renderer_jax.runtime.streaming.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from renderer_jax.scene.types import (
    Instances,
    Lights,
    Materials,
    MeshLibrary,
    Scene,
    SceneLimits,
)


@dataclasses.dataclass
class HostMesh:
    """One mesh's attribute arrays on the host (numpy)."""

    positions: np.ndarray  # (V, 3) f32
    indices: np.ndarray    # (T, 3) i32, mesh-local
    normals: Optional[np.ndarray] = None   # (V, 3)
    uvs: Optional[np.ndarray] = None       # (V, 2)
    tangents: Optional[np.ndarray] = None  # (V, 4)
    lods: Optional[list] = None            # list of (Ti, 3) index arrays (LOD1+)

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32)
        self.indices = np.ascontiguousarray(np.asarray(self.indices, np.int32)).reshape(-1, 3)
        v = len(self.positions)
        if self.normals is None:
            self.normals = compute_vertex_normals(self.positions, self.indices)
        if self.uvs is None:
            self.uvs = np.zeros((v, 2), np.float32)
        if self.tangents is None:
            self.tangents = np.zeros((v, 4), np.float32)
            self.tangents[:, 0] = 1.0
            self.tangents[:, 3] = 1.0


def sort_tris_for_clusters(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reorder one LOD range's triangles by the Morton code of their
    octahedral-mapped face normal, so consecutive CLUSTER-sized groups share
    tight normal cones (raw index order often wraps whole azimuth bands —
    e.g. a ring of a UV sphere — making cones near-hemispheric and
    backface culling useless: measured 0.5% cluster cull rate unsorted)."""
    v = positions[indices]
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(fn, axis=-1, keepdims=True)
    n = fn / np.maximum(ln, 1e-12)
    # octahedral map to [0,1]^2
    denom = np.abs(n).sum(axis=-1, keepdims=True)
    p = n[:, :2] / np.maximum(denom, 1e-12)
    neg = n[:, 2] < 0
    fold = (1.0 - np.abs(p[:, ::-1])) * np.where(p >= 0, 1.0, -1.0)
    p = np.where(neg[:, None], fold, p)
    q = np.clip(((p * 0.5 + 0.5) * 1023).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    key = spread(q[:, 0]) | (spread(q[:, 1]) << 1)
    return indices[np.argsort(key, kind="stable")]


def compute_cluster_data(
    positions: np.ndarray, indices: np.ndarray, real: np.ndarray
) -> np.ndarray:
    """Per-cluster bounding sphere + normal cone (object space).

    indices: (T, 3) with T a CLUSTER multiple; real: (T,) mask excluding the
    range-padding degenerates. Clusters whose normals are degenerate or
    spread beyond ~84 degrees store sin > 1, disabling backface culling for
    that cluster (frustum sphere culling still applies)."""
    from renderer_jax.scene.types import CL_COLS, CLUSTER

    t = len(indices)
    ncl = t // CLUSTER
    v = positions[indices].reshape(ncl, CLUSTER, 3, 3)
    rm = real.reshape(ncl, CLUSTER)
    fn = np.cross(v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0])  # (C, 32, 3)
    ln = np.linalg.norm(fn, axis=-1)
    ok_n = rm & (ln > 1e-12)
    n_unit = fn / np.maximum(ln, 1e-12)[..., None]

    out = np.zeros((ncl, CL_COLS), np.float32)
    w = rm[..., None, None].astype(np.float32)
    denom = np.maximum(rm.sum(axis=1), 1)[:, None]
    verts = v.reshape(ncl, CLUSTER * 3, 3)
    wv = np.repeat(rm, 3, axis=1)[..., None]
    center = (verts * wv).sum(axis=1) / np.maximum(wv.sum(axis=1), 1)
    radius = np.sqrt(
        np.max(
            np.where(wv[..., 0], ((verts - center[:, None]) ** 2).sum(-1), 0.0),
            axis=1,
        )
    )
    axis = (n_unit * ok_n[..., None]).sum(axis=1)
    alen = np.linalg.norm(axis, axis=-1)
    axis = axis / np.maximum(alen, 1e-12)[:, None]
    cosang = np.where(ok_n, (n_unit * axis[:, None]).sum(-1), 1.0).min(axis=1)
    degenerate = (rm & ~ok_n).any(axis=1) | (alen < 1e-6) | (cosang < 0.1)
    cosang = np.clip(cosang, -1.0, 1.0)
    sinang = np.sqrt(np.maximum(1.0 - cosang * cosang, 0.0))
    sinang = np.where(degenerate, 2.0, sinang)  # 2.0 => never backface-cull
    del denom, w
    out[:, 0:3] = center
    out[:, 3] = radius
    out[:, 4:7] = axis
    out[:, 7] = np.where(degenerate, -1.0, cosang)
    out[:, 8] = sinang
    out[:, 9] = rm.sum(axis=1)  # CL_COUNT: real prefix length
    return out


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    p = positions
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(p[i1] - p[i0], p[i2] - p[i0])  # area-weighted face normals
    n = np.zeros_like(p)
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(lens, 1e-20)).astype(np.float32)


class SceneBuilder:
    def __init__(self, limits: SceneLimits = SceneLimits(), atlas_size: int = 256):
        from renderer_jax.scene.textures import TextureAtlasBuilder

        self.limits = limits
        self.atlas = TextureAtlasBuilder(size=atlas_size, max_layers=limits.max_textures)
        self._meshes: list[HostMesh] = []
        self._materials: list[dict] = []
        self._instances: list[dict] = []
        self._lights: list[dict] = []
        self._skins: list[dict] = []

    def add_texture(self, img) -> int:
        """Add a texture image; returns atlas layer id for material fields."""
        return self.atlas.add(img)

    # -- meshes ------------------------------------------------------------
    def add_mesh(self, mesh: HostMesh, auto_lods: bool = False) -> int:
        """auto_lods generates a simplified LOD chain with the native
        grid-clustering simplifier (meshopt-parity; scene/simplify.py)."""
        if len(self._meshes) >= self.limits.max_meshes:
            raise ValueError("mesh library full")
        if auto_lods and mesh.lods is None and len(mesh.indices) > 64:
            from renderer_jax.scene.simplify import build_lod_chain

            mesh.lods = build_lod_chain(mesh.positions, mesh.indices)
        self._meshes.append(mesh)
        return len(self._meshes) - 1

    def add_skinned_mesh(
        self,
        mesh: HostMesh,
        joints: np.ndarray,        # (V, 4) i32
        weights: np.ndarray,       # (V, 4) f32, rows sum to 1
        parents: np.ndarray,       # (J,) i32, -1 root, parent idx < child idx
        inverse_bind: np.ndarray,  # (J, 4, 4)
        key_times: np.ndarray,     # (K,)
        key_t: np.ndarray,         # (K, J, 3)
        key_r: np.ndarray,         # (K, J, 4) quat (w,x,y,z)
        key_s: np.ndarray = None,  # (K, J)
        interpolation: str = "LINEAR",
        key_t_tangents=None,
        key_r_tangents=None,
        key_s_tangents=None,
    ) -> int:
        """Add a mesh with linear-blend skinning + one animation clip
        (interpolation/tangents as in add_skin_clip)."""
        lim = self.limits
        if len(self._skins) >= lim.max_skins:
            raise ValueError("skin table full")
        j = len(parents)
        k = len(key_times)
        if j > lim.max_joints:
            raise ValueError(f"too many joints ({j} > {lim.max_joints})")
        if k > lim.max_keyframes:
            raise ValueError(f"too many keyframes ({k} > {lim.max_keyframes})")
        for jj, p in enumerate(np.asarray(parents)):
            if p >= jj:
                raise ValueError("parents must be topologically ordered (parent < child)")
        mesh_id = self.add_mesh(mesh)
        self._skins.append(
            dict(
                mesh_id=mesh_id,
                joints=np.asarray(joints, np.int32),
                weights=np.asarray(weights, np.float32),
                parents=np.asarray(parents, np.int32),
                inverse_bind=np.asarray(inverse_bind, np.float32),
                clips=[],
            )
        )
        self.add_skin_clip(
            mesh_id, key_times, key_t, key_r, key_s,
            interpolation=interpolation,
            key_t_tangents=key_t_tangents,
            key_r_tangents=key_r_tangents,
            key_s_tangents=key_s_tangents,
        )
        return mesh_id

    def add_skin_clip(
        self,
        mesh_id: int,
        key_times: np.ndarray,       # (K,)
        key_t: np.ndarray,           # (K, J, 3)
        key_r: np.ndarray,           # (K, J, 4) quat (w,x,y,z)
        key_s: np.ndarray = None,    # (K, J)
        interpolation: str = "LINEAR",  # LINEAR | STEP | CUBICSPLINE
        key_t_tangents=None,         # (in, out) pair of (K, J, 3) for cubic
        key_r_tangents=None,         # (in, out) pair of (K, J, 4)
        key_s_tangents=None,         # (in, out) pair of (K, J)
    ) -> int:
        """Add an animation clip to a skinned mesh; returns the clip index
        (select at runtime via skins.active_clip / ops.skin.set_active_clip).
        glTF interpolation modes; CUBICSPLINE takes per-key in/out tangents."""
        from renderer_jax.scene.types import (
            INTERP_CUBICSPLINE,
            INTERP_LINEAR,
            INTERP_STEP,
        )

        skin = next((d for d in self._skins if d["mesh_id"] == mesh_id), None)
        if skin is None:
            raise ValueError(f"mesh {mesh_id} is not skinned")
        if len(skin["clips"]) >= self.limits.max_clips:
            raise ValueError("clip table full")
        k = len(key_times)
        j = len(skin["parents"])
        if k > self.limits.max_keyframes:
            raise ValueError(f"too many keyframes ({k} > {self.limits.max_keyframes})")
        mode = {"LINEAR": INTERP_LINEAR, "STEP": INTERP_STEP,
                "CUBICSPLINE": INTERP_CUBICSPLINE}[interpolation]
        zero3 = np.zeros((k, j, 3), np.float32)
        zero4 = np.zeros((k, j, 4), np.float32)
        zero1 = np.zeros((k, j), np.float32)
        t_in, t_out = key_t_tangents or (zero3, zero3)
        r_in, r_out = key_r_tangents or (zero4, zero4)
        s_in, s_out = key_s_tangents or (zero1, zero1)
        skin["clips"].append(
            dict(
                key_times=np.asarray(key_times, np.float32),
                key_t=np.asarray(key_t, np.float32),
                key_r=np.asarray(key_r, np.float32),
                key_s=np.ones((k, j), np.float32) if key_s is None else np.asarray(key_s, np.float32),
                key_t_in=np.asarray(t_in, np.float32),
                key_t_out=np.asarray(t_out, np.float32),
                key_r_in=np.asarray(r_in, np.float32),
                key_r_out=np.asarray(r_out, np.float32),
                key_s_in=np.asarray(s_in, np.float32),
                key_s_out=np.asarray(s_out, np.float32),
                interp=mode,
            )
        )
        return len(skin["clips"]) - 1

    # -- materials ----------------------------------------------------------
    def add_material(
        self,
        base_color=(1.0, 1.0, 1.0, 1.0),
        metallic=0.0,
        roughness=0.8,
        emissive=(0.0, 0.0, 0.0),
        base_color_tex=-1,
        normal_tex=-1,
    ) -> int:
        if len(self._materials) >= self.limits.max_materials:
            raise ValueError("material table full")
        self._materials.append(
            dict(
                base_color=np.asarray(base_color, np.float32),
                metallic=float(metallic),
                roughness=float(roughness),
                emissive=np.asarray(emissive, np.float32),
                base_color_tex=int(base_color_tex),
                normal_tex=int(normal_tex),
            )
        )
        return len(self._materials) - 1

    # -- instances ----------------------------------------------------------
    def add_instance(
        self,
        mesh_id: int,
        material_id: int = 0,
        translation=(0.0, 0.0, 0.0),
        rotation=(1.0, 0.0, 0.0, 0.0),
        scale=1.0,
    ) -> int:
        if len(self._instances) >= self.limits.max_instances:
            raise ValueError("instance table full")
        self._instances.append(
            dict(
                mesh_id=int(mesh_id),
                material_id=int(material_id),
                translation=np.asarray(translation, np.float32),
                rotation=np.asarray(rotation, np.float32),
                scale=float(scale),
            )
        )
        return len(self._instances) - 1

    # -- lights ---------------------------------------------------------------
    def add_light(
        self, position, color=(1.0, 1.0, 1.0), intensity=1.0, directional=False,
        shadow_slot=-1,
    ) -> int:
        if len(self._lights) >= self.limits.max_lights:
            raise ValueError("light table full")
        self._lights.append(
            dict(
                position=np.asarray(position, np.float32),
                color=np.asarray(color, np.float32),
                intensity=float(intensity),
                directional=bool(directional),
                shadow_slot=int(shadow_slot),
            )
        )
        return len(self._lights) - 1

    # -- freeze ---------------------------------------------------------------
    def build(self, texture_slots: int = None) -> Scene:
        """Consolidate into the fixed-capacity Scene pytree (numpy arrays;
        jnp promotes on first device use). texture_slots preallocates extra
        atlas layers for runtime texture streaming."""
        import jax.numpy as jnp

        lim = self.limits
        L = MeshLibrary.MAX_LODS

        lib = {
            k: (np.array(v) if v is not None else None)
            for k, v in MeshLibrary.empty(lim)._asdict().items()
        }

        from renderer_jax.scene.types import CLUSTER

        def ceil_cl(t):
            return -(-t // CLUSTER) * CLUSTER

        voff = 0
        toff = 0
        real_tri = np.zeros(lim.max_triangles, bool)  # excludes cluster padding
        for m, mesh in enumerate(self._meshes):
            v = len(mesh.positions)
            lods = [mesh.indices] + list(mesh.lods or [])
            if len(lods) > L:
                raise ValueError(f"too many LODs ({len(lods)} > {L})")
            # every LOD range is padded to a CLUSTER multiple (degenerate
            # zero-index triangles) so cluster ids are just tri_index//CLUSTER
            total_t = sum(ceil_cl(len(ix)) for ix in lods)
            if voff + v > lim.max_vertices or toff + total_t > lim.max_triangles:
                raise ValueError("mesh library capacity exceeded")
            lib["positions"][voff : voff + v] = mesh.positions
            lib["normals"][voff : voff + v] = mesh.normals
            lib["uvs"][voff : voff + v] = mesh.uvs
            lib["tangents"][voff : voff + v] = mesh.tangents
            lib["mesh_vertex_offset"][m] = voff
            lib["mesh_vertex_count"][m] = v
            lib["mesh_aabb_min"][m] = mesh.positions.min(axis=0)
            lib["mesh_aabb_max"][m] = mesh.positions.max(axis=0)
            for l, ix in enumerate(lods):
                ix = np.ascontiguousarray(np.asarray(ix, np.int32)).reshape(-1, 3)
                t = len(ix)
                if t > CLUSTER:
                    ix = sort_tris_for_clusters(mesh.positions, ix)
                lib["indices"][toff : toff + t] = ix + voff
                lib["lod_index_offset"][m, l] = toff
                lib["lod_tri_count"][m, l] = t
                real_tri[toff : toff + t] = True
                toff += ceil_cl(t)
            # missing LOD slots fall back to the last available LOD
            for l in range(len(lods), L):
                lib["lod_index_offset"][m, l] = lib["lod_index_offset"][m, len(lods) - 1]
                lib["lod_tri_count"][m, l] = lib["lod_tri_count"][m, len(lods) - 1]
            voff += v
        lib["vertex_count"] = np.int32(voff)
        lib["tri_count"] = np.int32(toff)
        lib["mesh_count"] = np.int32(len(self._meshes))
        if lib["tri_rec"] is not None and toff > 0:
            idx = lib["indices"][:toff]
            rec = np.concatenate(
                [
                    lib["positions"][idx].reshape(toff, 9),
                    lib["normals"][idx].reshape(toff, 9),
                    lib["uvs"][idx].reshape(toff, 6),
                    lib["tangents"][idx].reshape(toff, 12),
                ],
                axis=1,
            )
            rec[~real_tri[:toff]] = 0.0  # cluster padding: fully degenerate
            lib["tri_rec"][:toff] = rec
        if lib["cluster_data"] is not None and toff > 0:
            lib["cluster_data"][: toff // CLUSTER] = compute_cluster_data(
                lib["positions"], lib["indices"][:toff], real_tri[:toff]
            )
        meshes = MeshLibrary(
            **{k: (jnp.asarray(v) if v is not None else None) for k, v in lib.items()}
        )

        inst = {k: np.array(v) for k, v in Instances.empty(lim)._asdict().items()}
        for i, d in enumerate(self._instances):
            inst["translation"][i] = d["translation"]
            inst["rotation"][i] = d["rotation"]
            inst["scale"][i] = d["scale"]
            inst["mesh_id"][i] = d["mesh_id"]
            inst["material_id"][i] = d["material_id"]
            inst["alive"][i] = True
        inst["count"] = np.int32(len(self._instances))
        instances = Instances(**{k: jnp.asarray(v) for k, v in inst.items()})

        mats = {k: np.array(v) for k, v in Materials.empty(lim)._asdict().items()}
        for i, d in enumerate(self._materials):
            mats["base_color_factor"][i] = d["base_color"]
            mats["metallic"][i] = d["metallic"]
            mats["roughness"][i] = d["roughness"]
            mats["emissive"][i] = d["emissive"]
            mats["base_color_tex"][i] = d["base_color_tex"]
            mats["normal_tex"][i] = d["normal_tex"]
        mats["count"] = np.int32(len(self._materials))
        materials = Materials(**{k: jnp.asarray(v) for k, v in mats.items()})

        lts = {k: np.array(v) for k, v in Lights.empty(lim)._asdict().items()}
        for i, d in enumerate(self._lights):
            lts["position"][i] = d["position"]
            lts["color"][i] = d["color"]
            lts["intensity"][i] = d["intensity"]
            lts["directional"][i] = d["directional"]
            lts["shadow_slot"][i] = d["shadow_slot"]
            lts["alive"][i] = True
        lts["count"] = np.int32(len(self._lights))
        lights = Lights(**{k: jnp.asarray(v) for k, v in lts.items()})

        from renderer_jax.scene.types import Skins

        sk = {k: np.array(v) for k, v in Skins.empty(lim)._asdict().items()}
        for si, d in enumerate(self._skins):
            voff = int(lib["mesh_vertex_offset"][d["mesh_id"]])
            v = len(d["joints"])
            j = len(d["parents"])
            sk["joints"][voff : voff + v] = d["joints"]
            sk["weights"][voff : voff + v] = d["weights"]
            sk["vertex_skin"][voff : voff + v] = si
            sk["parents"][si, :j] = d["parents"]
            sk["inverse_bind"][si, :j] = d["inverse_bind"]
            sk["joint_count"][si] = j
            for ci, clip in enumerate(d["clips"]):
                k = len(clip["key_times"])
                sk["key_times"][si, ci, :k] = clip["key_times"]
                sk["key_times"][si, ci, k:] = clip["key_times"][-1]  # clamp pad
                for name in ("key_t", "key_r", "key_s", "key_t_in", "key_t_out",
                             "key_r_in", "key_r_out", "key_s_in", "key_s_out"):
                    sk[name][si, ci, :k, :j] = clip[name]
                    sk[name][si, ci, k:, :j] = clip[name][-1]
                sk["key_count"][si, ci] = k
                sk["duration"][si, ci] = clip["key_times"][-1]
                sk["interp"][si, ci] = clip["interp"]
            sk["clip_count"][si] = len(d["clips"])
            sk["mesh_skin"][d["mesh_id"]] = si
        sk["count"] = np.int32(len(self._skins))
        skins = Skins(**{k: jnp.asarray(v) for k, v in sk.items()})

        return Scene(
            meshes=meshes, instances=instances, materials=materials, lights=lights,
            atlas=self.atlas.build(preallocate=texture_slots), skins=skins,
        )
