"""The port's spans and counters (``utils.timing``): nothing recorded and no
profiler call without a profiler; under ``torch.profiler`` the span tree of
a Session's steps over a streamed world, with its chunk loads, the
counters, and the same pool and stats as an untraced twin; each profiler
session's records alone."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.app.session import Session
from octree_tracer_tpu_torch.gen import procedural
from octree_tracer_tpu_torch.utils import timing
from octree_tracer_tpu_torch.world.world import World

RES = 32
POS = np.array([0.25, 0.35, -2.3], np.float32)
LOOK = np.array([-0.12, -0.17, 1.0], np.float32)

# Each span's parent in a Session step (the engine's parts sit under either
# engine call). ``session.render`` and ``session.update`` are roots, each
# opening a step id; ``world.load_chunk`` runs on the World's IO thread, a
# root there carrying the id of the update that asked for it.
ROOTS = ("session.render", "session.update")
PARENT = {
    "session.plan": "session.render", "render.raygen": "session.render",
    "render.frame": "session.render",
    "render.trace": "render.frame", "render.shadow": "render.frame",
    "render.shade": "render.frame",
    "session.readback_wait": "session.update", "session.engine": "session.update",
    "session.patches": "session.update", "session.select": "session.update",
    "engine.subdivide": "session.engine", "engine.collapse": "session.engine",
}
ENGINE_PARTS = ("engine.views", "engine.pool", "engine.native", "engine.sync")


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    """A chunk_depth 3, world_depth 1 generated world: the root's children
    are chunk references, so a Session's first subdivisions load chunks."""
    path = str(tmp_path_factory.mktemp("spans") / "world")
    World(load_blocks=False).generate_world(
        path, procedural.Procedural(chunk_depth=3, device="cpu"), world_depth=1)
    return path


def _session(world_dir):
    s = Session(World.load_world(world_dir, load_blocks=False), RES, RES,
                pool_capacity=4096, device="cpu")
    s.character.pos, s.character.look = POS.copy(), LOOK.copy()
    s.settings.fov = 70.0
    return s


def _steps(s, n):
    stats = []
    for _ in range(n):
        stats.append(s.step()[2])
        s.world.wait_for_loads()
    return stats


def test_untraced_span_is_a_shared_no_op(monkeypatch):
    """Without a profiler a span is one shared object that enters no
    ``record_function`` and reads no clock, and nothing is stored, through
    whole Session steps."""
    def boom(*a, **k):
        raise AssertionError("entered without a profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(timing.time, "perf_counter_ns", boom)
    timing.clear()
    assert timing.span("a.b") is timing.span("c.d")
    with timing.span("a.b") as inner:
        assert inner is None and timing.current_step() is None
        timing.count("a.n", 3)
    s = Session(scenes.shell_world(6), RES, RES, pool_capacity=4096, device="cpu")
    s.character.pos, s.character.look = POS.copy(), LOOK.copy()
    assert sum(s.step()[2]["subdivided"] for _ in range(2)) > 0
    assert timing.records() == [] and timing.dropped() == 0


def test_traced_steps_give_the_span_tree(world_dir):
    s = _session(world_dir)
    _steps(s, 1)  # selects; the traced steps apply, load chunks, subdivide
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = _steps(s, 2)
    recs = timing.records()
    spans = [r for r in recs if isinstance(r, timing.Span)]
    by_id = {r.id: r for r in spans}
    roots = [r for r in spans if r.name in ROOTS]
    assert sorted(r.name for r in roots) == sorted(ROOTS * 2)
    updates = {r.step for r in roots if r.name == "session.update"}
    for r in spans:
        if r.name == "world.load_chunk":
            assert r.parent is None and r.step in updates
            continue
        if r.name in ROOTS:
            assert r.parent is None and r.step == r.id
            continue
        p = by_id[r.parent]
        want = ("engine.subdivide", "engine.collapse") if r.name in ENGINE_PARTS \
            else (PARENT[r.name],)
        assert p.name in want, (r.name, p.name)
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        assert r.step == p.step and r.thread == p.thread
    names = {r.name for r in spans}
    assert set(PARENT) | set(ENGINE_PARTS) | set(ROOTS) | {"world.load_chunk"} <= names
    # Each load carries the step whose engine asked for it.
    loads = [r for r in spans if r.name == "world.load_chunk"]
    syncs = {r.step for r in spans if r.name == "engine.sync"}
    assert loads and all(r.step in syncs for r in loads)
    # The calling thread's spans are the profiler's user annotations too.
    annotations = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    assert names - {"world.load_chunk"} <= annotations
    counts = [r for r in recs if isinstance(r, timing.Count)]
    assert sum(c.n for c in counts if c.name == "engine.subdivided") \
        == sum(st["subdivided"] for st in stats) > 0
    assert sum(c.n for c in counts if c.name == "engine.sub_read") >= \
        sum(st["subdivided"] for st in stats)
    # The frame's counter carries its render's step, one a frame; every
    # other counter its update's.
    renders = {r.step for r in roots if r.name == "session.render"}
    assert {c.step for c in counts if c.name != "session.skip_live"} <= updates
    assert sorted(c.step for c in counts if c.name == "session.skip_live") == sorted(renders)


def test_patched_slots_count_each_steps_drain(world_dir):
    """``session.patched_slots`` adds, under each traced update, the slots
    that step's patch journal drained (its ``patched`` stat), and the
    benchmark's ``patched_slots.fly`` reads their sum over the stretch's
    steps; without a profiler nothing is recorded."""
    from types import SimpleNamespace

    from portbench import harness

    s = _session(world_dir)
    timing.clear()
    assert sum(st["patched"] for st in _steps(s, 3)) > 0
    assert timing.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        stats = _steps(s, 3)
    recs = timing.records()
    updates = sorted((r.start_ns, r.step) for r in recs
                     if isinstance(r, timing.Span) and r.name == "session.update")
    counts = [r for r in recs if isinstance(r, timing.Count)
              and r.name == "session.patched_slots"]
    assert [sum(c.n for c in counts if c.step == step) for _, step in updates] \
        == [st["patched"] for st in stats]
    assert len(counts) == 3 and sum(c.n for c in counts) > 0
    read = harness.reader("patched_slots.fly")
    bench = harness.benchmark()
    fly, orbit = (harness.cell_spec(bench, cell)["traffic"]
                  for cell in ("island9-fly-noskip", "shell10-orbit"))
    run = SimpleNamespace(traffic=fly, trace={"ops": 3})
    assert read(run) == pytest.approx(sum(st["patched"] for st in stats) / 3)
    assert read(SimpleNamespace(traffic=orbit, trace={"ops": 3})) is None
    assert read(SimpleNamespace(traffic=fly, trace=None)) is None
    timing.clear()  # a program without the counter
    assert read(run) is None


def test_warp_builds_count_each_whole_table_build(monkeypatch):
    """``session.warp_builds`` adds one under each ``session.warp_build``
    span, one a whole-table build (``Session._build_table``), in its
    render's step; ``session.skip_rebuilds`` one a skip-half rebuild."""
    from octree_tracer_tpu_torch.app import session

    monkeypatch.setattr(session, "WARP_LEVELS", 5)
    calls = {"build": 0, "rebuild": 0}
    build, rebuild = Session._build_table, Session._rebuild_skip_half

    def spy_build(self, combined):
        calls["build"] += 1
        build(self, combined)

    def spy_rebuild(self):
        calls["rebuild"] += 1
        rebuild(self)

    monkeypatch.setattr(Session, "_build_table", spy_build)
    monkeypatch.setattr(Session, "_rebuild_skip_half", spy_rebuild)
    s = Session(scenes.shell_world(7), RES, RES, pool_capacity=1 << 18, device="cpu")
    s.character.pos = np.array([0.25, 0.35, -1.3], np.float32)
    s.character.look = np.array([-0.12, -0.17, 1.0], np.float32)
    s.settings.warp_pool_words = 1
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(18):
            if i >= 10:
                s.character.turn(60.0, 0.0, fov=90.0)
            s.step()
    recs = timing.records()
    spans = [r for r in recs if isinstance(r, timing.Span)]
    renders = {r.step for r in spans if r.name == "session.render"}
    builds = [r for r in spans if r.name == "session.warp_build"]
    counts = [r for r in recs if isinstance(r, timing.Count) and r.name == "session.warp_builds"]
    rebuilds = [r for r in recs if isinstance(r, timing.Count)
                and r.name == "session.skip_rebuilds"]
    assert sum(c.n for c in counts) == len(counts) == len(builds) == calls["build"] > 1
    assert sorted(c.step for c in counts) == sorted(r.step for r in builds)
    assert {c.step for c in counts} <= renders
    assert sum(c.n for c in rebuilds) == calls["rebuild"] > 0


def test_traced_session_equals_untraced_twin(world_dir):
    a, b = _session(world_dir), _session(world_dir)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _steps(a, 3)
    assert traced == _steps(b, 3)
    np.testing.assert_array_equal(state.to_numpy_u32(a.device_words),
                                  state.to_numpy_u32(b.device_words))
    assert set(a.world.chunks) == set(b.world.chunks)


def test_store_is_bounded(monkeypatch):
    monkeypatch.setattr(timing, "STORE_LIMIT", 3)
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            timing.count("x.n")
    assert len(timing.records()) == 3 and timing.dropped() == 2
    timing.clear()
    assert timing.records() == [] and timing.dropped() == 0


def test_each_profiler_session_starts_from_an_empty_store():
    """Records of an earlier profiled stretch, and anything left in the
    store, are gone once the next profiler session starts, whoever
    started it."""
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("first.a"):
            timing.count("first.n", 2)
    assert {r.name for r in timing.records()} == {"first.a", "first.n"}
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("second.a"):
            timing.count("second.n")
    assert {r.name for r in timing.records()} == {"second.a", "second.n"}
