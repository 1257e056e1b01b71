"""The readers of the program's spans and counters (``portbench/spans.py``)
on a synthetic store: sums over the traced stretch's operations, a span's
self time as the span less the union of its children, a counter ratio, and
None on an untraced run, on the other driver and from a program without
records."""

from types import SimpleNamespace

import pytest

from octree_tracer_tpu_torch.utils import timing
from portbench import harness, spans

MS = 1_000_000  # ns
FLY = ["engine_ms.fly", "engine_glue_ms.fly", "patch_ms.fly", "select_ms.fly",
       "readback_wait_ms.fly", "update_self_ms.fly", "subdivide_yield.fly"]


def span(name, id_, parent, start_ms, end_ms, step=1):
    return timing.Span(name, id_, parent, 7, step, start_ms * MS, end_ms * MS)


# Two steps: update 1 (0-100 ms) and update 20 (200-260 ms).
STORE = [
    span("session.readback_wait", 2, 1, 0, 5),
    span("engine.native", 5, 4, 10, 14),
    span("engine.sync", 6, 4, 14, 20),
    span("engine.subdivide", 4, 3, 8, 20),
    span("engine.native", 8, 7, 21, 22),
    span("engine.collapse", 7, 3, 20, 24),
    timing.Count("engine.sub_read", 40, 1),
    timing.Count("engine.subdivided", 10, 1),
    span("session.engine", 3, 1, 6, 30),
    span("session.patches", 9, 1, 25, 50),  # overlaps the engine: counted once
    span("session.select", 10, 1, 60, 90),
    span("session.update", 1, None, 0, 100),
    span("world.load_chunk", 11, None, 40, 140),  # the IO thread: no parent
    span("session.readback_wait", 22, 20, 203, 207),
    timing.Count("engine.sub_read", 60, 20),
    timing.Count("engine.subdivided", 40, 20),
    span("engine.native", 25, 23, 210, 213),
    span("session.engine", 23, 20, 207, 227),
    span("session.select", 24, 20, 230, 250),
    span("session.update", 20, None, 200, 260, step=20),
    span("render.raygen", 30, 29, 300, 301, step=29),
    span("render.frame", 31, 29, 301, 305, step=29),
]


def run(driver, trace=True):
    return SimpleNamespace(traffic={"driver": driver},
                           trace={"ops": 2} if trace else None)


@pytest.fixture
def store(monkeypatch):
    monkeypatch.setattr(timing, "records", lambda: list(STORE))


def read(name, r):
    return harness.reader(name)(r)


def test_span_means_over_the_stretch(store):
    r = run("fly")
    assert read("engine_ms.fly", r) == pytest.approx((24 + 20) / 2)
    assert read("patch_ms.fly", r) == pytest.approx(25 / 2)
    assert read("select_ms.fly", r) == pytest.approx((30 + 20) / 2)
    assert read("readback_wait_ms.fly", r) == pytest.approx((5 + 4) / 2)
    # session.engine less the library calls under it (4 + 1 + 3 ms).
    assert read("engine_glue_ms.fly", r) == pytest.approx((24 + 20 - 8) / 2)
    assert read("enqueue_ms.orbit", run("orbit")) == pytest.approx((1 + 4) / 2)


def test_update_self_is_the_span_less_its_childrens_union(store):
    # Update 1: children 0-5, 6-30, 25-50, 60-90 cover 5 + 44 + 30 = 79 of
    # 100 ms (the engine's own children and the IO thread's load do not
    # count). Update 20: 203-207, 207-227, 230-250 cover 44 of 60.
    assert read("update_self_ms.fly", run("fly")) == pytest.approx((21 + 16) / 2)
    assert spans.union_ns([(0, 5), (3, 4), (4, 9), (10, 12)]) == 11


def test_subdivide_yield(store, monkeypatch):
    assert read("subdivide_yield.fly", run("fly")) == pytest.approx(100 * 50 / 100)
    monkeypatch.setattr(timing, "records", lambda: [timing.Count("engine.sub_read", 0, 1)])
    assert read("subdivide_yield.fly", run("fly")) is None


def test_none_untraced_other_driver_or_no_records(store, monkeypatch):
    for name in FLY:
        assert read(name, run("fly", trace=False)) is None
        assert read(name, run("orbit")) is None
    assert read("enqueue_ms.orbit", run("fly")) is None
    assert read("enqueue_ms.orbit", run("orbit", trace=False)) is None
    # A program older than its spans: no records() to read.
    monkeypatch.delattr(timing, "records")
    for name in FLY + ["enqueue_ms.orbit"]:
        assert read(name, run("orbit" if name.endswith("orbit") else "fly")) is None
    # A store with none of the spans read.
    monkeypatch.setattr(timing, "records", lambda: [], raising=False)
    assert read("engine_ms.fly", run("fly")) is None
    assert read("update_self_ms.fly", run("fly")) is None


def test_a_second_traced_stretch_reads_its_own_records():
    """Two profiled stretches in one process (as the card tests run several
    traced cells): the readers see the second stretch's spans alone."""
    from torch.profiler import ProfilerActivity, profile

    def stretch(engine_calls):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(engine_calls):
                with timing.span("session.update"), timing.span("session.engine"):
                    timing.count("engine.sub_read", 4)
                    timing.count("engine.subdivided", 1)

    stretch(5)
    stretch(2)
    assert sum(isinstance(r, timing.Span) and r.name == "session.engine"
               for r in timing.records()) == 2
    assert read("subdivide_yield.fly", run("fly")) == pytest.approx(25.0)
    assert read("engine_ms.fly", run("fly")) is not None
