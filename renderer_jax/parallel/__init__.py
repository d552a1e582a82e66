"""Multi-device SPMD rendering over a jax.sharding.Mesh.

The reference's concurrency is intra-GPU (async compute/transfer queues,
timeline semaphores — SURVEY.md §2 'Parallelism strategies'). The
multi-device scaling story is SPMD over a device mesh:

- geometry parallel (the DP axis): instances are sharded across devices;
  each device expands + culls + compacts its shard of the draw stream, then
  the compacted soups are all-gathered over the interconnect (the
  collective analogue of the reference's queue-ownership transfer of the
  culled draw stream);
- image-space parallel (the SP axis): the framebuffer is row-sharded; each
  device rasterizes + shades only its rows against the gathered soup
  (split-frame rendering).
"""

from renderer_jax.parallel.sharding import (  # noqa: F401
    make_mesh,
    render_frame_spmd,
)
