"""Multi-chip SPMD rendering: a thin driver over the frame graph.

The graph itself is SPMD-aware (passes.pipeline.build_forward_graph with
PipelineConfig.spmd_devices > 1): instance-sharded geometry, ONE all-gather
of the culled draw stream, row-sharded raster/shade, and a final
row all-gather in the present pass. Renderer(spmd_mesh=mesh) wraps the whole
compiled plan in a single shard_map whose per-resource partition specs come
from the graph declarations — every runtime switch (shadows, occlusion
culling, rt, freeze, hud, ssaa, skinning) runs under SPMD through the SAME
plan, identical to single-device given adequate per-device capacity
(tests/test_parallel.py) except where two coplanar triangles tie in depth:
the first in stream order wins, and the gathered stream is ordered device
by device.

This module keeps only mesh construction (a flat device axis: the cards
of one host are joined all to all) and a convenience one-shot driver.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

AXIS = "sp"


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis,))


def render_frame_spmd(
    scene,
    camera,
    mesh: Mesh,
    width: int,
    height: int,
    tri_capacity_per_device: int = 2048,
    shading: str = "pbr",
    background=(0.05, 0.05, 0.08),
    **switches,
):
    """One frame through the SPMD frame graph. Returns (image, depth, tri_id)
    — image fully assembled (replicated), depth/tri_id row-sharded arrays."""
    from renderer_jax.passes.pipeline import PipelineConfig
    from renderer_jax.runtime import Renderer

    n_dev = mesh.shape[AXIS]
    cfg = PipelineConfig(
        width=width,
        height=height,
        tri_capacity=tri_capacity_per_device * n_dev,
        use_pallas=True,
        shading=shading,
        background=background,
        spmd_devices=n_dev,
        spmd_axis=AXIS,
    )
    r = Renderer(scene, cfg, outputs=("image", "vis"), spmd_mesh=mesh)
    if switches:
        r.set_config(**switches)
        r.apply_config_now()
    out = r.render(camera)
    return out["image"], out["vis"].depth, out["vis"].tri_id
