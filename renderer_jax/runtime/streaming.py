"""Async scene streaming: decode on host threads, upload on a frame budget.

The reference streams glTF scenes with bevy task pools: parse/decode tasks
off-thread, then `upload_loaded_meshes` integrates at most 8 meshes per frame
into the consolidated buffers (scene_loader.rs:102-613, budget at :166),
with staging buffers destroyed a few frames later (deferred per swapchain
slot, scene_loader.rs:588-613).

Equivalent here: decode (glTF parse, normal generation, texture resize) runs
in a ThreadPoolExecutor; upload staging goes through the native arena
(runtime/allocator.py) so repeated uploads reuse the same host memory, with
frees deferred two pumps (the swapchain-slot deferral analogue — the H2D
copy has certainly drained by then); `pump()` integrates up to `budget`
decoded meshes per frame through pre-compiled DONATED upload programs
(dynamic_update_slice at traced offsets — no per-mesh recompiles), looping
the fixed-shape chunk program for meshes of any size. Textures land through
one donated program updating every mip level in a single XLA computation
(no full-atlas copies per mip).
"""

from __future__ import annotations

import functools
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from renderer_jax.scene.builder import HostMesh
from renderer_jax.scene.types import Scene

# streamed meshes are uploaded in fixed-size chunks so a handful of compiled
# programs serves every upload (ref: fixed staging buffer sizes); meshes
# larger than a chunk loop the same program over consecutive chunks
CHUNK_VERTS = 4096
CHUNK_TRIS = 8192


@functools.partial(jax.jit, donate_argnums=0)
def _upload_vert_chunk(scene: Scene, pos, nrm, uv, tan, v_off):
    lib = scene.meshes
    du = jax.lax.dynamic_update_slice
    return scene._replace(
        meshes=lib._replace(
            positions=du(lib.positions, pos, (v_off, 0)),
            normals=du(lib.normals, nrm, (v_off, 0)),
            uvs=du(lib.uvs, uv, (v_off, 0)),
            tangents=du(lib.tangents, tan, (v_off, 0)),
        )
    )


@functools.partial(jax.jit, donate_argnums=0)
def _upload_index_chunk(scene: Scene, idx, t_off, n_real):
    """Index upload also refreshes the chunk's tri_rec rows (the wide
    per-triangle attribute records the fast expansion path gathers) and its
    cluster_data rows (sphere + normal cone for cluster culling) — the
    mesh's vertex chunks land first, so the attribute pools are current.
    Chunks are CLUSTER-aligned (t_off and the chunk length are multiples of
    32); rows past n_real are range padding (degenerate)."""
    from renderer_jax.scene.types import CL_COLS, CLUSTER

    lib = scene.meshes
    new_lib = lib._replace(
        indices=jax.lax.dynamic_update_slice(lib.indices, idx, (t_off, 0))
    )
    nrows = idx.shape[0]
    real = jnp.arange(nrows) < n_real
    if lib.tri_rec is not None:
        rows = jnp.concatenate(
            [
                new_lib.positions[idx].reshape(nrows, 9),
                new_lib.normals[idx].reshape(nrows, 9),
                new_lib.uvs[idx].reshape(nrows, 6),
                new_lib.tangents[idx].reshape(nrows, 12),
            ],
            axis=1,
        )
        rows = jnp.where(real[:, None], rows, 0.0)
        new_lib = new_lib._replace(
            tri_rec=jax.lax.dynamic_update_slice(lib.tri_rec, rows, (t_off, 0))
        )
    if lib.cluster_data is not None and nrows % CLUSTER == 0:
        ncl = nrows // CLUSTER
        v = new_lib.positions[idx].reshape(ncl, CLUSTER, 3, 3)
        rm = real.reshape(ncl, CLUSTER)
        fn = jnp.cross(v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0])
        ln = jnp.linalg.norm(fn, axis=-1)
        ok_n = rm & (ln > 1e-12)
        n_unit = fn / jnp.maximum(ln, 1e-12)[..., None]
        wv = jnp.repeat(rm, 3, axis=1)[..., None]
        verts = v.reshape(ncl, CLUSTER * 3, 3)
        center = (verts * wv).sum(axis=1) / jnp.maximum(wv.sum(axis=1), 1)
        radius = jnp.sqrt(
            jnp.max(
                jnp.where(wv[..., 0], ((verts - center[:, None]) ** 2).sum(-1), 0.0),
                axis=1,
            )
        )
        axis = (n_unit * ok_n[..., None]).sum(axis=1)
        alen = jnp.linalg.norm(axis, axis=-1)
        axis = axis / jnp.maximum(alen, 1e-12)[:, None]
        cosang = jnp.where(ok_n, (n_unit * axis[:, None]).sum(-1), 1.0).min(axis=1)
        degenerate = (rm & ~ok_n).any(axis=1) | (alen < 1e-6) | (cosang < 0.1)
        cosang = jnp.clip(cosang, -1.0, 1.0)
        sinang = jnp.sqrt(jnp.maximum(1.0 - cosang * cosang, 0.0))
        crows = jnp.concatenate(
            [
                center,
                radius[:, None],
                axis,
                jnp.where(degenerate, -1.0, cosang)[:, None],
                jnp.where(degenerate, 2.0, sinang)[:, None],
                rm.sum(axis=1).astype(jnp.float32)[:, None],  # CL_COUNT
                jnp.zeros((ncl, CL_COLS - 10), jnp.float32),
            ],
            axis=1,
        )
        new_lib = new_lib._replace(
            cluster_data=jax.lax.dynamic_update_slice(
                lib.cluster_data, crows, (t_off // CLUSTER, 0)
            )
        )
    return scene._replace(meshes=new_lib)


@functools.partial(jax.jit, donate_argnums=0)
def _finalize_mesh(
    scene: Scene, mesh_slot, v_off, v_count, t_off, t_count,
    lod_offsets, lod_counts, aabb_min, aabb_max,
):
    lib = scene.meshes
    m = mesh_slot
    return scene._replace(
        meshes=lib._replace(
            mesh_vertex_offset=lib.mesh_vertex_offset.at[m].set(v_off),
            mesh_vertex_count=lib.mesh_vertex_count.at[m].set(v_count),
            lod_index_offset=lib.lod_index_offset.at[m].set(lod_offsets),
            lod_tri_count=lib.lod_tri_count.at[m].set(lod_counts),
            mesh_aabb_min=lib.mesh_aabb_min.at[m].set(aabb_min),
            mesh_aabb_max=lib.mesh_aabb_max.at[m].set(aabb_max),
            vertex_count=jnp.maximum(lib.vertex_count, v_off + v_count),
            tri_count=jnp.maximum(lib.tri_count, t_off + t_count),
            mesh_count=jnp.maximum(lib.mesh_count, m + 1),
        )
    )


@functools.partial(jax.jit, donate_argnums=0)
def _spawn_instance(scene: Scene, slot, mesh_id, material_id, translation, rotation, scale):
    inst = scene.instances
    return scene._replace(
        instances=inst._replace(
            translation=inst.translation.at[slot].set(translation),
            rotation=inst.rotation.at[slot].set(rotation),
            scale=inst.scale.at[slot].set(scale),
            mesh_id=inst.mesh_id.at[slot].set(mesh_id),
            material_id=inst.material_id.at[slot].set(material_id),
            alive=inst.alive.at[slot].set(True),
            count=jnp.maximum(inst.count, slot + 1),
        )
    )


def _split_mips(flat, sizes):
    """Static-shape split of one concatenated mip buffer (see below)."""
    mips = []
    off = 0
    for n in sizes:
        mips.append(jax.lax.dynamic_slice(flat, (off,), (n,)))
        off += n
    return mips


@functools.partial(jax.jit, donate_argnums=0, static_argnames=("sizes",))
def _upload_texture_mips(packed, level_offset, layer, flat, *, sizes):
    """Write one texture's full mip stack into its atlas layer in ONE donated
    program: every dynamic_update_slice aliases the same donated buffer, so
    there are zero full-atlas copies (mip sizes are static per atlas config,
    so one compiled program serves every streamed texture). The whole stack
    arrives as ONE concatenated device buffer — per-mip eager transfers
    would cost one host-to-device transfer EACH."""
    for lvl, w in enumerate(_split_mips(flat, sizes)):
        start = level_offset[lvl] + layer * w.shape[0]
        packed = jax.lax.dynamic_update_slice(packed, w, (start,))
    return packed


@functools.partial(jax.jit, donate_argnums=0, static_argnames=("sizes",))
def _upload_texture_quads(quad, level_offset, layer, flat, *, sizes):
    """Refresh the layer's quad-table rows (the one-gather filtering
    accelerator, scene/textures.py) from its freshly staged mips — same
    donated-single-program, single-transfer pattern as
    _upload_texture_mips."""
    from renderer_jax.scene.textures import QUAD_COLS, quad_rows_for_layer

    imgs = []
    for w in _split_mips(flat, sizes):
        s = int(round(np.sqrt(w.shape[0])))
        imgs.append(w.reshape(s, s))
    rows = quad_rows_for_layer(imgs, xp=jnp)
    pack = quad.shape[1] // QUAD_COLS
    for lvl, r in enumerate(rows):
        start = level_offset[lvl] + layer * r.shape[0]
        # QUAD_PACK texels share a physical row; level blocks are pack-
        # aligned by construction (scene/textures.py), so the packed view of
        # this level's rows is a clean rectangle
        from renderer_jax.scene.textures import pack_quad_rows

        r = pack_quad_rows(r, pack, xp=jnp)
        quad = jax.lax.dynamic_update_slice(quad, r, (start // pack, 0))
    return quad


@functools.partial(jax.jit, static_argnames=("cols",))
def _quad_bl_prefix(quad, cols: int):
    return quad[:, :cols]


class SceneStreamer:
    """Streams meshes into a live Scene with a per-frame upload budget."""

    def __init__(self, scene: Scene, budget: int = 8, workers: int = 2, arena=None):
        self.scene = scene
        self.budget = budget  # ref: <=8 mesh uploads per frame
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._pending: list[Future] = []
        self._ready: list[tuple] = []
        self._v_off = int(scene.meshes.vertex_count)
        self._t_off = int(scene.meshes.tri_count)
        self._mesh_slot = int(scene.meshes.mesh_count)
        self._inst_slot = int(scene.instances.count)
        self.arena = arena
        # arena blocks freed two pumps after their upload was issued (the
        # deferred staging destruction of the reference, scene_loader.rs)
        self._deferred_free: list[list[np.ndarray]] = [[], []]
        # texture layer slots: bump allocation from the scene's committed
        # count, with a free list so released layers recycle
        self._next_tex_layer = int(np.asarray(scene.atlas.n_layers))
        self._free_tex_layers: list[int] = []
        self.stats = {"requested": 0, "decoded": 0, "uploaded": 0, "frames": 0,
                      "chunks": 0}

    # -- producers ----------------------------------------------------------
    def request_mesh(self, source, material_id=0, translation=(0, 0, 0),
                     rotation=(1, 0, 0, 0), scale=1.0) -> None:
        """source: HostMesh, a path to .glb/.gltf, or a zero-arg callable
        returning HostMesh. Decode happens off-thread."""
        self.stats["requested"] += 1

        def decode():
            if isinstance(source, HostMesh):
                mesh = source
            elif callable(source):
                mesh = source()
            else:
                from renderer_jax.scene import SceneBuilder, SceneLimits
                from renderer_jax.scene.gltf import load_gltf

                # full default limits, not tiny(): the decode builder only
                # carries mesh/instance tables transiently, and a committed
                # asset (e.g. assets/colonnade.glb, 158 instances) overflows
                # tiny's instance table
                b = load_gltf(str(source), SceneBuilder(SceneLimits()))
                mesh = b._meshes[0]
            return (mesh, material_id, translation, rotation, scale)

        self._pending.append(self._pool.submit(decode))

    # -- per-frame integration ----------------------------------------------
    def pump(self) -> Scene:
        """Integrate up to `budget` decoded meshes; returns the live scene."""
        self.stats["frames"] += 1
        # retire staging blocks from two pumps ago
        if self.arena is not None:
            for blk in self._deferred_free.pop(0):
                self.arena.free(blk)
            self._deferred_free.append([])
        still = []
        for f in self._pending:
            if f.done():
                self._ready.append(f.result())
                self.stats["decoded"] += 1
            else:
                still.append(f)
        self._pending = still

        for _ in range(min(self.budget, len(self._ready))):
            item = self._ready.pop(0)
            if item[0] == "texture":
                _, layer, words = item
                self._upload_texture(layer, words)
            else:
                mesh, mat, t, r, s = item
                self._upload(mesh, mat, t, r, s)
            self.stats["uploaded"] += 1
        return self.scene

    # -- staging ------------------------------------------------------------
    def _stage(self, a: np.ndarray, n: int, tail: tuple) -> np.ndarray:
        """A zero-padded (n, *tail) staging copy of `a`. Arena-backed when an
        arena is attached (pinned host-memory reuse across uploads); the
        device copy reads straight from the arena block, which is freed two
        pumps later."""
        if self.arena is not None:
            buf = self.arena.alloc((n,) + tail, a.dtype)
            self._deferred_free[-1].append(buf)
        else:
            buf = np.empty((n,) + tail, a.dtype)
        buf[: len(a)] = a
        buf[len(a):] = 0
        return buf

    @staticmethod
    def _chunk_for(n, cap_left, biggest):
        """Smallest power-of-two tier >= n that still fits in cap_left.
        A handful of tiers keeps the set of compiled upload programs small;
        when no tier fits but the data itself does, fall back to an
        exact-fit chunk (one extra compile near capacity exhaustion beats a
        spurious MemoryError with slots still free). Chunks stay CLUSTER-
        aligned when possible so index uploads refresh cluster_data rows."""
        for c in (256, 1024, biggest):
            if n <= c <= cap_left:
                return c
        n32 = -(-n // 32) * 32
        if n32 <= cap_left:
            return n32
        if n <= cap_left:
            return n  # last slots at exact capacity (cluster rows skipped)
        return None

    def _upload(self, mesh: HostMesh, material_id, translation, rotation, scale):
        v = len(mesh.positions)
        tcnt = len(mesh.indices)
        lib = self.scene.meshes
        v_cap = lib.positions.shape[0]
        t_cap = lib.indices.shape[0]
        tpad = -(-tcnt // 32) * 32  # keep ranges CLUSTER-aligned
        if self._v_off + v > v_cap or self._t_off + tpad > t_cap:
            # unaligned last-resort fit is only safe when no cluster tables
            # exist — a misaligned range would make cluster ids point into
            # ANOTHER mesh's cluster_data (wrong culling beats no mesh, so
            # fail cleanly instead)
            if lib.cluster_data is None:
                tpad = tcnt
        if self._v_off + v > v_cap or self._t_off + tpad > t_cap:
            raise MemoryError(
                f"mesh library capacity exhausted during streaming "
                f"({v} verts / {tcnt} tris vs {v_cap - self._v_off} / "
                f"{t_cap - self._t_off} left)"
            )

        # vertex chunks: full CHUNK_VERTS programs, tier-sized tail
        off = 0
        while off < v:
            n = min(CHUNK_VERTS, v - off)
            chunk = self._chunk_for(n, v_cap - (self._v_off + off), CHUNK_VERTS)
            assert chunk is not None  # capacity checked above
            self.scene = _upload_vert_chunk(
                self.scene,
                jnp.asarray(self._stage(mesh.positions[off:off + n], chunk, (3,))),
                jnp.asarray(self._stage(mesh.normals[off:off + n], chunk, (3,))),
                jnp.asarray(self._stage(mesh.uvs[off:off + n], chunk, (2,))),
                jnp.asarray(self._stage(mesh.tangents[off:off + n], chunk, (4,))),
                jnp.int32(self._v_off + off),
            )
            self.stats["chunks"] += 1
            off += n

        # index chunks (library-global vertex ids)
        idx_global = mesh.indices.astype(np.int32) + self._v_off
        off = 0
        while off < tcnt:
            n = min(CHUNK_TRIS, tcnt - off)
            chunk = self._chunk_for(n, t_cap - (self._t_off + off), CHUNK_TRIS)
            assert chunk is not None
            self.scene = _upload_index_chunk(
                self.scene,
                jnp.asarray(self._stage(idx_global[off:off + n], chunk, (3,))),
                jnp.int32(self._t_off + off),
                jnp.int32(n),
            )
            self.stats["chunks"] += 1
            off += n

        n_lods = lib.lod_index_offset.shape[1]
        self.scene = _finalize_mesh(
            self.scene,
            jnp.int32(self._mesh_slot),
            jnp.int32(self._v_off), jnp.int32(v),
            jnp.int32(self._t_off), jnp.int32(tcnt),
            jnp.full((n_lods,), self._t_off, jnp.int32),
            jnp.full((n_lods,), tcnt, jnp.int32),
            jnp.asarray(mesh.positions.min(axis=0)),
            jnp.asarray(mesh.positions.max(axis=0)),
        )
        self.scene = _spawn_instance(
            self.scene,
            jnp.int32(self._inst_slot),
            jnp.int32(self._mesh_slot),
            jnp.int32(material_id),
            jnp.asarray(translation, jnp.float32),
            jnp.asarray(rotation, jnp.float32),
            jnp.float32(scale),
        )
        self._v_off += v
        self._t_off += tpad
        self._mesh_slot += 1
        self._inst_slot += 1

    # -- texture streaming -----------------------------------------------
    def request_texture(self, img) -> int:
        """Queue a texture for upload into a preallocated atlas layer (the
        scene must have been built with SceneBuilder(..).build/preallocated
        atlas slots). Returns the layer id to use in materials NOW — the
        slot shows white until the upload lands."""
        atlas = self.scene.atlas
        n_total = atlas.packed_u32.shape[0]
        # layer capacity from shapes: total = n_layers * sum(s_l^2)
        sizes = np.asarray(atlas.level_size)
        per_layer = int((sizes.astype(np.int64) ** 2).sum())
        n_layers = n_total // per_layer
        if self._free_tex_layers:
            layer = self._free_tex_layers.pop()
        else:
            layer = self._next_tex_layer
            if layer >= n_layers:
                raise MemoryError(
                    f"atlas layer slots exhausted during streaming "
                    f"({n_layers} total; release_texture recycles slots)"
                )
            self._next_tex_layer += 1
        self.stats["requested"] += 1

        def decode():
            from renderer_jax.scene.textures import build_mips

            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
            if arr.shape[-1] == 3:
                arr = np.concatenate(
                    [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=-1
                )
            size = int(sizes[0])
            if arr.shape[:2] != (size, size):
                from renderer_jax.utils.image import pil_image

                Image = pil_image()
                arr = np.asarray(Image.fromarray(arr).resize((size, size), Image.BILINEAR))
            mips = build_mips(arr)
            words = []
            for m in mips:
                p = m.reshape(-1, 4).astype(np.uint32)
                words.append(p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16) | (p[:, 3] << 24))
            return ("texture", layer, words)

        self._pending.append(self._pool.submit(decode))
        return layer

    def release_texture(self, layer: int) -> None:
        """Return a streamed layer's slot to the free list (the descriptor-
        slot recycle of the reference's bindless arrays). The caller must
        stop referencing the layer in materials first; the texels stay
        until a new request overwrites them."""
        committed = int(np.asarray(self.scene.atlas.n_layers))
        if layer < committed or layer >= self._next_tex_layer:
            raise ValueError(f"layer {layer} was not streamed by this streamer")
        if layer in self._free_tex_layers:
            raise ValueError(f"layer {layer} already released")
        self._free_tex_layers.append(layer)

    def _upload_texture(self, layer: int, words: list) -> None:
        atlas = self.scene.atlas
        # ONE staged transfer for the whole mip stack (each eager per-mip
        # jnp.asarray is a transfer of its own); the donated programs split
        # it with static slices
        flat = np.concatenate(words)
        sizes = tuple(len(w) for w in words)
        staged = jnp.asarray(self._stage(flat, len(flat), ()))
        packed = _upload_texture_mips(
            atlas.packed_u32,
            atlas.level_offset,
            jnp.int32(layer),
            staged,
            sizes=sizes,
        )
        new_atlas = atlas._replace(packed_u32=packed)
        if atlas.quad_u32 is not None:
            new_quad = _upload_texture_quads(
                atlas.quad_u32, atlas.level_offset, jnp.int32(layer),
                staged, sizes=sizes,
            )
            new_atlas = new_atlas._replace(
                quad_u32=new_quad,
                # refresh the dedicated bilinear-prefix table (one jitted
                # slice of the packed table; see TextureAtlas.quad_bl_u32 —
                # an EAGER slice here was one more device dispatch per
                # upload and a narrow-table materialization)
                quad_bl_u32=(
                    None if atlas.quad_bl_u32 is None
                    else _quad_bl_prefix(new_quad, 4 * atlas.quad_pack)
                ),
            )
        self.scene = self.scene._replace(atlas=new_atlas)

    def close(self):
        self._pool.shutdown(wait=False)
        if self.arena is not None:
            jax.block_until_ready(jax.tree_util.tree_leaves(self.scene))
            for batch in self._deferred_free:
                for blk in batch:
                    self.arena.free(blk)
            self._deferred_free = [[], []]
