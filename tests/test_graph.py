"""Frame-graph compiler tests: validation, culling, plan cache, persistence.

These are the test-suite analogue of the reference's compile-time validators
(SURVEY.md §4 item 1) — but as real unit + property tests.
"""

import numpy as np
import pytest

from renderer_jax.graph import FrameGraph, GraphError
from renderer_jax.graph.core import PlanCache
from renderer_jax.graph.dot import graph_to_dot, plan_to_dot


def linear_graph():
    g = FrameGraph("test")
    g.resource("inp", external=True)
    g.resource("a")
    g.resource("b")
    g.resource("out")
    g.add_pass("p1", lambda inp: inp + 1, reads=["inp"], writes=["a"])
    g.add_pass("p2", lambda a: a * 2, reads=["a"], writes=["b"])
    g.add_pass("p3", lambda b: b - 3, reads=["b"], writes=["out"])
    return g


def test_linear_execution():
    g = linear_graph()
    plan = g.compile(outputs=["out"])
    out, state = plan.execute({}, inp=10)
    assert out["out"] == (10 + 1) * 2 - 3
    assert state == {}
    assert [p.name for p in plan.passes] == ["p1", "p2", "p3"]


def test_declaration_order_independent():
    """Toposort must order by dependency, not declaration."""
    g = FrameGraph("test")
    g.resource("inp", external=True)
    g.resource("a")
    g.resource("out")
    g.add_pass("late", lambda a: a * 2, reads=["a"], writes=["out"])
    g.add_pass("early", lambda inp: inp + 1, reads=["inp"], writes=["a"])
    plan = g.compile(outputs=["out"])
    assert [p.name for p in plan.passes] == ["early", "late"]
    out, _ = plan.execute({}, inp=1)
    assert out["out"] == 4


def test_dead_write_elimination():
    """Passes whose results are never read are culled (ref:
    renderer.rs:3455-3529 'computed-but-unused work')."""
    g = linear_graph()
    g.resource("unused")
    executed = []

    def spy(a):
        executed.append("dead")
        return a

    g.add_pass("dead", spy, reads=["a"], writes=["unused"])
    plan = g.compile(outputs=["out"])
    assert "dead" not in [p.name for p in plan.passes]
    plan.execute({}, inp=0)
    assert executed == []
    # but requesting 'unused' as output keeps it
    plan2 = g.compile(outputs=["out", "unused"])
    assert "dead" in [p.name for p in plan2.passes]


def test_transitive_dead_elimination():
    """A chain feeding only a dead pass dies entirely."""
    g = linear_graph()
    g.resource("c1")
    g.resource("c2")
    g.add_pass("chain1", lambda a: a, reads=["a"], writes=["c1"])
    g.add_pass("chain2", lambda c1: c1, reads=["c1"], writes=["c2"])
    plan = g.compile(outputs=["out"])
    names = [p.name for p in plan.passes]
    assert "chain1" not in names and "chain2" not in names


def test_conditional_culling_and_plan_cache():
    g = FrameGraph("test")
    g.switch("fancy")
    g.resource("inp", external=True)
    g.resource("out")
    g.add_pass("plain", lambda inp: inp, reads=["inp"], writes=["out"], condition="!fancy")
    g.add_pass("fancy_p", lambda inp: inp * 100, reads=["inp"], writes=["out"], condition="fancy")
    cache = PlanCache(g, outputs=["out"])
    p_off = cache.plan({"fancy": False})
    p_on = cache.plan({"fancy": True})
    assert [p.name for p in p_off.passes] == ["plain"]
    assert [p.name for p in p_on.passes] == ["fancy_p"]
    assert cache.plan({"fancy": False}) is p_off  # memoized
    assert p_on.execute({}, inp=2)[0]["out"] == 200


def test_persistent_resource_freeze_semantics():
    """Culling the producer of a persistent resource serves last frame's
    value — the freeze_culling behavior (cull_pipeline.rs:331-421) without a
    bypass copy pass."""
    g = FrameGraph("test")
    g.switch("freeze")
    g.resource("inp", external=True)
    g.resource("soup", persistent=True, init=lambda: np.float32(-1.0))
    g.resource("img")
    g.add_pass("cull", lambda inp: inp * 2, reads=["inp"], writes=["soup"], condition="!freeze")
    g.add_pass("draw", lambda soup: soup + 0.5, reads=["soup"], writes=["img"])
    cache = PlanCache(g, outputs=["img"])

    state = cache.plan().initial_state()
    out, state = cache.plan({"freeze": False}).execute(state, inp=np.float32(10))
    assert out["img"] == 20.5
    # frozen: draw must reuse last frame's soup (20), not see inp=999
    out, state2 = cache.plan({"freeze": True}).execute(state, inp=np.float32(999))
    assert out["img"] == 20.5
    assert state2["soup"] == state["soup"]


def test_reads_prev_gets_last_frame():
    """reads_prev delivers frame N-1's value even when frame N rewrites it
    (two-pass occlusion culling pattern)."""
    g = FrameGraph("test")
    g.resource("inp", external=True)
    g.resource("depth", persistent=True, init=lambda: np.float32(0.0))
    g.resource("out")
    g.add_pass("render", lambda inp: inp, reads=["inp"], writes=["depth"])
    g.add_pass(
        "occlusion",
        lambda inp, depth_prev: inp + depth_prev,
        reads=["inp"],
        reads_prev=["depth"],
        writes=["out"],
    )
    plan = g.compile(outputs=["out"])
    state = plan.initial_state()
    out, state = plan.execute(state, inp=np.float32(5))
    assert out["out"] == 5.0  # prev depth was 0
    out, state = plan.execute(state, inp=np.float32(7))
    assert out["out"] == 12.0  # prev depth was 5


# -- validation errors ----------------------------------------------------

def test_error_undeclared_resource():
    g = FrameGraph("t")
    g.resource("out")
    g.add_pass("p", lambda x: x, reads=["x"], writes=["out"])
    with pytest.raises(GraphError, match="undeclared resource"):
        g.validate()


def test_error_cycle():
    g = FrameGraph("t")
    g.resource("a")
    g.resource("b")
    g.add_pass("p1", lambda b: b, reads=["b"], writes=["a"])
    g.add_pass("p2", lambda a: a, reads=["a"], writes=["b"])
    with pytest.raises(GraphError, match="cyclic|can produce"):
        g.compile(outputs=["a"])


def test_error_double_unconditional_writer():
    g = FrameGraph("t")
    g.resource("a")
    g.add_pass("p1", lambda: {"a": 1}, writes=["a"])
    g.add_pass("p2", lambda: {"a": 2}, writes=["a"])
    with pytest.raises(GraphError, match="multiple passes"):
        g.validate()


def test_error_unknown_switch():
    g = FrameGraph("t")
    g.resource("a")
    g.add_pass("p", lambda: {"a": 1}, writes=["a"], condition="nope")
    with pytest.raises(GraphError, match="undeclared switch"):
        g.validate()


def test_error_write_external():
    g = FrameGraph("t")
    g.resource("inp", external=True)
    g.add_pass("p", lambda: {"inp": 1}, writes=["inp"])
    with pytest.raises(GraphError, match="writes external"):
        g.validate()


def test_error_wrong_return_keys():
    g = FrameGraph("t")
    g.resource("a")
    g.resource("b")
    g.add_pass("p", lambda: {"a": 1}, writes=["a", "b"])
    plan = g.compile(outputs=["a", "b"])
    with pytest.raises(GraphError, match="returned"):
        plan.execute({})


def test_error_output_unproducible():
    g = FrameGraph("t")
    g.switch("on")
    g.resource("a")
    g.add_pass("p", lambda: {"a": 1}, writes=["a"], condition="on")
    plan = g.compile(outputs=["a"], switches={"on": False})
    with pytest.raises(GraphError, match="not produced"):
        plan.execute({})


# -- property test: random DAGs always validate + execute consistently -----

def test_property_random_dags():
    rng = np.random.default_rng(42)
    for trial in range(20):
        n = int(rng.integers(3, 12))
        g = FrameGraph(f"rand{trial}")
        g.resource("inp", external=True)
        names = []
        for i in range(n):
            rname = f"r{i}"
            g.resource(rname)
            # read from a random subset of earlier resources (ensures DAG)
            pool = ["inp"] + names
            k = int(rng.integers(1, min(3, len(pool)) + 1))
            reads = list(rng.choice(pool, size=k, replace=False))
            g.add_pass(
                f"p{i}",
                (lambda _reads: (lambda **kw: sum(kw[r] for r in _reads)))(reads),
                reads=reads,
                writes=[rname],
            )
            names.append(rname)
        out_res = names[-1]
        plan = g.compile(outputs=[out_res])
        # executing must satisfy all reads (toposort correct by construction)
        out, _ = plan.execute({}, inp=1)
        assert np.isfinite(out[out_res])
        # order respects dependencies
        pos = {p.name: i for i, p in enumerate(plan.passes)}
        by_writer = {w: p.name for p in plan.passes for w in p.writes}
        for p in plan.passes:
            for r in p.reads:
                if r in by_writer:
                    assert pos[by_writer[r]] < pos[p.name]


def test_dot_dumps():
    g = linear_graph()
    plan = g.compile(outputs=["out"])
    d1 = graph_to_dot(g)
    d2 = plan_to_dot(plan)
    assert "digraph" in d1 and "p2" in d1 and "res:a" in d1
    assert "digraph" in d2 and '"p1" -> "p2"' in d2
