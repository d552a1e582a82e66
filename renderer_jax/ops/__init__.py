"""Compute kernels: geometry transforms, culling/compaction, rasterization,
texture sampling, shading — the array-program equivalents of the
reference's GLSL shaders (src/shaders/)."""
