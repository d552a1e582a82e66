"""Frame-graph core: declaration, validation, culling, plan compilation."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence


class GraphError(ValueError):
    """Raised for invalid graph declarations (the analogue of the reference's
    build-time panics in macrolib.rs / resource_claims.rs)."""


@dataclasses.dataclass(frozen=True)
class Resource:
    """A named frame resource.

    persistent=True means the resource survives across frames (double
    buffered by the runtime): if its producing pass is culled this frame,
    readers see last frame's value — the reference's freeze-culling bypass
    semantics without the copy pass.
    external=True marks per-frame inputs (scene, camera, switches' payload).
    """

    name: str
    persistent: bool = False
    external: bool = False
    # optional initializer for persistent resources: () -> pytree
    init: Optional[Callable[[], Any]] = None
    # informational only (diagnostics/.dot parity with the reference)
    desc: str = ""
    # SPMD partition specs (pytree / prefix of jax.sharding.PartitionSpec)
    # for this resource's value when the plan runs under shard_map; None =
    # replicated. Only consulted for persistent resources and outputs.
    spmd_specs: Any = None


@dataclasses.dataclass(frozen=True)
class Pass:
    """A render/compute pass: a pure function from read resources to written
    resources.

    fn(**reads) -> dict mapping written resource names to values (a lone
    value is accepted when the pass writes exactly one resource).

    condition: switch expression string — "rt", "!debug_aabbs", or a
    sequence meaning AND (the reference's `if [RT, !DEBUG_AABB]` clauses,
    macrolib Conditional). Evaluated against the plan's switch dict; False
    culls the pass at trace time.

    queue: purely informational under XLA ("graphics"/"compute"/"transfer"),
    kept for .dot parity with the reference's queue-colored graphs.
    """

    name: str
    fn: Callable[..., Any]
    reads: tuple
    writes: tuple
    condition: tuple = ()
    queue: str = "graphics"
    # reads of *last frame's* value of persistent resources (no dependency
    # edge; delivered to fn as '<name>_prev'). This is how two-pass occlusion
    # culling reads frame N-1's depth pyramid while frame N rewrites it.
    reads_prev: tuple = ()


def _normalize_condition(condition) -> tuple:
    if condition is None:
        return ()
    if isinstance(condition, str):
        return (condition,)
    return tuple(condition)


def eval_condition(condition: tuple, switches: Mapping[str, bool]) -> bool:
    """AND of terms; each term is 'name' or '!name'."""
    for term in condition:
        neg = term.startswith("!")
        name = term[1:] if neg else term
        if name not in switches:
            raise GraphError(f"unknown switch {name!r} in condition {condition}")
        v = bool(switches[name])
        if v == neg:
            return False
    return True


class FrameGraph:
    """Builder + compiler for a frame's pass graph."""

    def __init__(self, name: str):
        self.name = name
        self.resources: dict[str, Resource] = {}
        self.passes: list[Pass] = []
        self._switch_names: set[str] = set()

    # -- declaration -------------------------------------------------------
    def resource(
        self, name: str, *, persistent=False, external=False, init=None, desc="",
        spmd_specs=None,
    ) -> str:
        if name in self.resources:
            raise GraphError(f"resource {name!r} declared twice")
        self.resources[name] = Resource(
            name=name, persistent=persistent, external=external, init=init,
            desc=desc, spmd_specs=spmd_specs,
        )
        return name

    def switch(self, name: str, *names: str) -> None:
        """Declare runtime switches (the RuntimeConfiguration booleans,
        ref: ecs.rs:240-277)."""
        for n in (name, *names):
            self._switch_names.add(n)

    def add_pass(
        self, name, fn, *, reads=(), writes=(), condition=None, queue="graphics",
        reads_prev=(),
    ):
        if any(p.name == name for p in self.passes):
            raise GraphError(f"pass {name!r} declared twice")
        p = Pass(
            name=name,
            fn=fn,
            reads=tuple(reads),
            writes=tuple(writes),
            condition=_normalize_condition(condition),
            queue=queue,
            reads_prev=tuple(reads_prev),
        )
        if not p.writes:
            raise GraphError(f"pass {name!r} writes nothing")
        self.passes.append(p)
        return p

    # decorator sugar
    def pass_(
        self, name, *, reads=(), writes=(), condition=None, queue="graphics",
        reads_prev=(),
    ):
        def deco(fn):
            self.add_pass(
                name, fn, reads=reads, writes=writes, condition=condition,
                queue=queue, reads_prev=reads_prev,
            )
            return fn

        return deco

    # -- validation ----------------------------------------------------------
    def validate(self) -> None:
        """Static validation, independent of switches (the build-time checks:
        resource_claims.rs:58-69 all-steps-claimed / all-resources-defined,
        macrolib.rs:1182-1185 acyclicity)."""
        writers: dict[str, list[str]] = {}
        for p in self.passes:
            for term in p.condition:
                n = term[1:] if term.startswith("!") else term
                if n not in self._switch_names:
                    raise GraphError(
                        f"pass {p.name!r} conditioned on undeclared switch {n!r}"
                    )
            for r in p.reads + p.writes + p.reads_prev:
                if r not in self.resources:
                    raise GraphError(f"pass {p.name!r} claims undeclared resource {r!r}")
            for r in p.reads_prev:
                if not self.resources[r].persistent:
                    raise GraphError(
                        f"pass {p.name!r} reads_prev non-persistent resource {r!r}"
                    )
            for w in p.writes:
                if self.resources[w].external:
                    raise GraphError(f"pass {p.name!r} writes external resource {w!r}")
                writers.setdefault(w, []).append(p.name)
        for r, ws in writers.items():
            # multiple writers are allowed only if their conditions are
            # mutually exclusive on some switch (e.g. cull vs cull_bypass);
            # full exclusivity is re-checked per switch set at compile time.
            if len(ws) > 1:
                conds = [p.condition for p in self.passes if p.name in ws]
                if any(not c for c in conds):
                    raise GraphError(
                        f"resource {r!r} written by multiple passes {ws} and at "
                        "least one is unconditional"
                    )
        # every non-external resource read by someone must have a possible
        # writer or be persistent-with-init
        readable = {
            r.name
            for r in self.resources.values()
            if r.external or (r.persistent and r.init is not None)
        } | set(writers)
        for p in self.passes:
            for r in p.reads:
                if r not in readable:
                    raise GraphError(
                        f"pass {p.name!r} reads {r!r} which nothing can produce"
                    )
        # acyclicity of the full (uncull-ed) graph, treating persistent
        # resources read-before-write as last-frame reads (no edge)
        self._toposort(self.passes, check_only=True)

    def _toposort(self, passes: Sequence[Pass], check_only=False) -> list[Pass]:
        """Topological order by resource dependencies. A read of a persistent
        resource that is also written by an earlier-declared... no:
        persistent resources create an edge writer->reader ONLY when both are
        live this frame and the reader is not the writer; a persistent
        read with no live writer reads last frame's buffer."""
        writers: dict[str, list[Pass]] = {}
        for p in passes:
            for w in p.writes:
                writers.setdefault(w, []).append(p)
                if not check_only and len(writers[w]) > 1:
                    # conditional writers must be mutually exclusive; by the
                    # time a concrete plan is built only one may survive
                    raise GraphError(
                        f"resource {w!r} written by multiple passes "
                        f"{[q.name for q in writers[w]]} in the same plan "
                        "(conditions are not mutually exclusive)"
                    )
        # edges: producer -> consumer
        indeg = {p.name: 0 for p in passes}
        edges: dict[str, list[str]] = {p.name: [] for p in passes}
        for p in passes:
            for r in p.reads:
                for prod in writers.get(r, ()):
                    if prod.name != p.name:
                        edges[prod.name].append(p.name)
                        indeg[p.name] += 1
        # Kahn, deterministic by declaration order
        order: list[Pass] = []
        name2pass = {p.name: p for p in passes}
        ready = [p.name for p in passes if indeg[p.name] == 0]
        while ready:
            n = ready.pop(0)
            order.append(name2pass[n])
            for m in edges[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
            ready.sort(key=lambda nm: [q.name for q in passes].index(nm))
        if len(order) != len(passes):
            cyc = [n for n, d in indeg.items() if d > 0]
            raise GraphError(f"pass graph is cyclic through {cyc}")
        return order if not check_only else order

    # -- compilation -----------------------------------------------------------
    def compile(
        self,
        outputs: Sequence[str],
        switches: Optional[Mapping[str, bool]] = None,
    ) -> "CompiledPlan":
        """Build the executable plan for one switch configuration.

        Mirrors setup_submissions' 7-stage rebuild (renderer.rs:3368-3606):
        (1) cull passes with false conditions; (2/3) drop passes whose writes
        are never read (transitively), keeping output + persistent writers;
        (4) implicit — unreachable passes fall out of the same iteration;
        then toposort. 'Extra signals' and transitive reduction have no XLA
        analogue (no semaphores to keep in sync).
        """
        self.validate()
        switches = dict(switches or {})
        for s in self._switch_names:
            switches.setdefault(s, False)
        for o in outputs:
            if o not in self.resources:
                raise GraphError(f"requested output {o!r} is not a resource")

        live = [p for p in self.passes if eval_condition(p.condition, switches)]

        # iterative dead-write elimination
        while True:
            read_by_live = {r for p in live for r in p.reads}
            needed = set(outputs) | read_by_live
            keep = [
                p
                for p in live
                if any(
                    w in needed or self.resources[w].persistent for w in p.writes
                )
            ]
            if len(keep) == len(live):
                break
            live = keep

        order = self._toposort(live)
        return CompiledPlan(graph=self, passes=tuple(order), outputs=tuple(outputs), switches=switches)


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """An executable, jit-friendly frame plan for one switch configuration."""

    graph: FrameGraph
    passes: tuple
    outputs: tuple
    switches: Mapping[str, bool]

    def initial_state(self) -> dict:
        """Fresh persistent-resource state (call once, then thread through
        execute; the runtime double-buffers by carrying this pytree)."""
        state = {}
        for r in self.graph.resources.values():
            if r.persistent:
                if r.init is None:
                    raise GraphError(
                        f"persistent resource {r.name!r} needs init= for initial_state"
                    )
                state[r.name] = r.init()
        return state

    def execute(self, state: Mapping[str, Any], **external) -> tuple:
        """Run the plan. Returns (outputs dict, new persistent state dict).

        Pure function of (state, external inputs) — safe to jax.jit; all
        passes fuse into one XLA program (the XLA replacement for the
        reference's multi-queue submission engine)."""
        env: dict[str, Any] = dict(state)
        for k, v in external.items():
            if k not in self.graph.resources or not self.graph.resources[k].external:
                raise GraphError(f"unexpected external input {k!r}")
            env[k] = v
        for p in self.passes:
            missing = [r for r in p.reads if r not in env]
            if missing:
                raise GraphError(
                    f"pass {p.name!r} reads {missing} before any value exists "
                    "(not produced this frame, not persistent, not external)"
                )
            kwargs = {r: env[r] for r in p.reads}
            for r in p.reads_prev:
                if r not in state:
                    raise GraphError(
                        f"pass {p.name!r} reads_prev {r!r} but it is missing "
                        "from the persistent state (initial_state not used?)"
                    )
                kwargs[f"{r}_prev"] = state[r]
            import jax

            # f32 matmuls at full precision: geometry is f32 end to end, and
            # a default-precision dot may run in TF32 (~3 digits) on the GPU
            with jax.named_scope(f"{self.graph.name}.{p.name}"), \
                    jax.default_matmul_precision("highest"):
                result = p.fn(**kwargs)
            if len(p.writes) == 1 and not isinstance(result, dict):
                result = {p.writes[0]: result}
            if set(result.keys()) != set(p.writes):
                raise GraphError(
                    f"pass {p.name!r} returned {sorted(result)} but claims "
                    f"writes {sorted(p.writes)}"
                )
            env.update(result)
        missing_out = [o for o in self.outputs if o not in env]
        if missing_out:
            raise GraphError(
                f"outputs {missing_out} were not produced by any live pass "
                f"(culled by switches {dict(self.switches)}?)"
            )
        new_state = {
            r.name: env[r.name]
            for r in self.graph.resources.values()
            if r.persistent and r.name in env
        }
        return {o: env[o] for o in self.outputs}, new_state


    def execute_timed(self, state: Mapping[str, Any], iters: int = 5, **external):
        """DIAGNOSTIC: run the plan pass-by-pass, each pass as its own jitted
        program timed over `iters` chained device calls. Returns
        (outputs, new_state, {pass_name: mean_ms}).

        The per-pass numbers are the analogue of the reference's per-system
        GPU timestamps in its imgui panel (ecs.rs:293-409). They include one
        dispatch each and miss cross-pass fusion, so their sum exceeds the
        fused frame time — treat them as a cost BREAKDOWN, not a frame
        budget. Each pass is timed over `iters` calls ending in
        block_until_ready."""
        import time as _time

        import jax

        env: dict[str, Any] = dict(state)
        for k, v in external.items():
            if k not in self.graph.resources or not self.graph.resources[k].external:
                raise GraphError(f"unexpected external input {k!r}")
            env[k] = v
        timings: dict[str, float] = {}

        for p in self.passes:
            kwargs = {r: env[r] for r in p.reads}
            for r in p.reads_prev:
                kwargs[f"{r}_prev"] = state[r]

            def fn(kw, _p=p):
                with jax.default_matmul_precision("highest"):
                    return _p.fn(**kw)

            jfn = jax.jit(fn)
            result = jax.block_until_ready(jfn(kwargs))  # compile
            t0 = _time.perf_counter()
            for _ in range(max(1, iters)):
                result = jfn(kwargs)
            jax.block_until_ready(result)
            timings[p.name] = (_time.perf_counter() - t0) / max(1, iters) * 1e3
            if len(p.writes) == 1 and not isinstance(result, dict):
                result = {p.writes[0]: result}
            env.update(result)
        new_state = {
            r.name: env[r.name]
            for r in self.graph.resources.values()
            if r.persistent and r.name in env
        }
        return {o: env[o] for o in self.outputs if o in env}, new_state, timings


class PlanCache:
    """Memoizes CompiledPlans by switch set — the analogue of the reference's
    cached submission plans + per-permutation pipelines (renderer.rs:3389-3396,
    SmartPipeline specialization). jax.jit adds the XLA-level cache on top."""

    def __init__(self, graph: FrameGraph, outputs: Sequence[str]):
        self.graph = graph
        self.outputs = tuple(outputs)
        self._cache: dict[tuple, CompiledPlan] = {}

    def plan(self, switches: Optional[Mapping[str, bool]] = None) -> CompiledPlan:
        switches = dict(switches or {})
        for s in self.graph._switch_names:
            switches.setdefault(s, False)
        key = tuple(sorted(switches.items()))
        if key not in self._cache:
            self._cache[key] = self.graph.compile(self.outputs, switches)
        return self._cache[key]
