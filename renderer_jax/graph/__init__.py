"""Declarative frame graph -> fused XLA programs.

The reference's central design is a compile-time frame graph: proc macros
(define_pass!/define_resource!/barrier!, macros/macros.rs)
declare passes and resource claims, build.rs validates them and assigns
timeline semaphores (macro_lib/macrolib.rs:520-1225), and a
runtime planner culls passes per frame and emits barriers/submissions
(src/renderer.rs:3368-3878 setup_submissions /
update_submissions).

Under XLA the execution machinery disappears — XLA program order replaces
semaphores, queues, and barriers — but the *graph* remains valuable:

- declarative passes with read/write claims, validated at compile (trace)
  time: undefined resources, write-after-freeze, cycles, unclaimed steps;
- conditional passes culled per runtime-switch set (the reference's shader
  permutation matrix + 7-stage plan rebuild becomes: trace a different fused
  program per switch set, memoized in a plan cache);
- dead-write elimination (computed-but-never-read work dropped, mirroring
  renderer.rs:3455-3529);
- persistent (double-buffered) resources that carry across frames, which is
  how freeze-culling-style bypass passes work without copies
  (ref: cull_pipeline.rs:331-421 cull_pass_bypass);
- .dot dumps of the declared and culled graphs (ref: diagnostics/ +
  live-diagnostics/).
"""

from renderer_jax.graph.core import (  # noqa: F401
    FrameGraph,
    GraphError,
    Pass,
    Resource,
    CompiledPlan,
)
