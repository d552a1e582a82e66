"""renderer_jax — a software rendering framework on JAX/XLA/Pallas.

Rebuilds the capabilities of farnoy/renderer (a Rust/Vulkan GPU-driven renderer,
see SURVEY.md) as an array program for an accelerator (NVIDIA GPU):

- the ECS scene state becomes structure-of-arrays pytrees resident in device memory
  (``renderer_jax.scene``),
- the macro-generated frame graph becomes a declarative Python graph compiler
  that validates resource claims and emits fused, jitted frame programs
  (``renderer_jax.graph``),
- vertex transform / culling / draw compaction become batched matmuls and
  masked segment reductions (``renderer_jax.ops.geometry``, ``ops.cull``),
- the shader stages become array programs and Pallas kernels (Triton
  route), most notably a binned tile-based software rasterizer with depth
  testing (``renderer_jax.ops.raster_pallas``),
- Vulkan queues/semaphores/barriers are replaced by XLA program order and
  buffer donation (``renderer_jax.runtime``),
- the one native component (the reference's C++ VMA wrapper, vma/) is rebuilt
  as a C++ host staging-arena allocator with live stats
  (``renderer_jax.native``).
"""

__version__ = "0.1.0"
