"""The cell of the Session's shipped settings, ``shell10-fly``, found by
name: at a tiny size on the CPU its check passes the program's run and
fails a run whose counted frames leave the cells a skip jump crosses
unmarked (the skip half's fault in the collapse decisions, which the program
mends in ``tracer._jump_slots`` and K1's ``mark_jump``); and the readers of
the skip half's spans and counters on a synthetic store."""

import time
from types import SimpleNamespace

import pytest
import torch

from octree_tracer_tpu_torch.utils import timing
from portbench import harness

CELL = "shell10-fly"
SKIP = ["skip_rebuild_ms.fly", "skip_rebuilds.fly", "skip_live.fly"]


def test_cell_runs_the_shipped_settings():
    spec = harness.cell_spec(harness.benchmark(), CELL)
    assert "session" not in spec["settings"] and spec["config"]["reduced"] == []
    assert spec["settings"]["reduced"] == []
    assert spec["cell"]["traffic"] == "fly_shell" and spec["cell"]["chips"] == 1
    assert {m["name"] for m in spec["end_to_end"]} == {"step_ms", "setup_s"}
    names = {m["name"] for m in spec["per_layer"]}
    assert set(SKIP) <= names
    assert not names & {"chunk_loads.fly", "chunk_evictions.fly"}


def run_tiny(tiny, monkeypatch):
    """A 0.6 s run of the cell at a tiny size whose pool rides the combined
    table from its first frame, at a level the CPU builds in a moment."""
    from octree_tracer_tpu_torch.app import session

    spec = tiny(CELL)
    spec["settings"]["session"] = {"warp_pool_words": 1}
    monkeypatch.setattr(session, "WARP_LEVELS", 5)
    run = harness.execute(spec, 2**31 + 77, 0.6, False, torch.device("cpu"),
                          time.perf_counter())
    return harness.result_line(spec, run, False, {"platform": "cpu", "kind": "cpu", "count": 1})


def test_sound_run_is_correct(tiny, monkeypatch):
    line = run_tiny(tiny, monkeypatch)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_jumps_that_mark_nothing_are_caught(tiny, monkeypatch):
    """K1 as it was before the mend: a counted jump marks no cell it
    crosses, so interiors that only jumps cross are listed to collapse."""
    from octree_tracer_tpu_torch.render import tracer

    monkeypatch.setattr(tracer, "_jump_slots",
                        lambda *a, **k: torch.zeros(0, dtype=torch.int64))
    line = run_tiny(tiny, monkeypatch)
    checks = line["checks"]
    assert not line["correct"]
    assert checks["candidate_diff_pct"]["value"] > checks["candidate_diff_pct"]["limit"]
    assert checks["frame_diff_pct"]["value"] <= checks["frame_diff_pct"]["limit"]


MS = 1_000_000  # ns


def traced(driver="fly", ops=3):
    return SimpleNamespace(traffic={"driver": driver}, trace={"ops": ops})


def read(name, run):
    return harness.reader(name)(run)


def test_skip_readers(monkeypatch):
    store = [timing.Count("session.skip_live", 1, 1), timing.Count("session.skip_live", 0, 5),
             timing.Count("session.skip_live", 1, 9),
             timing.Span("session.skip_rebuild", 12, 11, 7, 9, 10 * MS, 16 * MS),
             timing.Count("session.skip_rebuilds", 1, 9)]
    monkeypatch.setattr(timing, "records", lambda: list(store))
    assert read("skip_live.fly", traced()) == pytest.approx(200 / 3)
    assert read("skip_rebuilds.fly", traced()) == pytest.approx(1 / 3)
    assert read("skip_rebuild_ms.fly", traced()) == pytest.approx(6 / 3)
    # A stretch that rebuilt nothing reads 0, not nothing.
    store[3:] = []
    assert read("skip_rebuilds.fly", traced()) == 0
    assert read("skip_rebuild_ms.fly", traced()) == 0
    # A program that does not count its frames' skip halves (the span alone,
    # as before), another driver, an untraced run: nothing to read.
    monkeypatch.setattr(timing, "records", lambda: [
        timing.Span("session.skip_rebuild", 12, 11, 7, 9, 10 * MS, 16 * MS)])
    for name in SKIP:
        assert read(name, traced()) is None
        assert read(name, traced("orbit")) is None
        assert read(name, SimpleNamespace(traffic={"driver": "fly"}, trace=None)) is None


W, H = 480, 270
# Where the rays stand: the depth-8 shell under a level-7 table from outside
# and from inside, where the rays jump the empty middle; and two pools whose
# pointers run past their end (``scenes.malformed_pools``) under a level-3
# table from inside the root cube, where the jumps mark slots both on the
# CPU's rays and on their shadow rays (moved_random) or on the primaries
# alone (ragged21).
CASES = {"outside": ("shell", 7, [0.2, 0.3, -2.4], [-0.1, -0.15, 1.0]),
         "inside": ("shell", 7, [0.05, 0.1, -0.3], [0.3, -0.2, 1.0]),
         "moved_random": ("moved_random", 3, [-0.35, 0.55, -0.6], [0.3, -0.5, 1.0]),
         "ragged21": ("ragged21", 3, [-0.35, 0.55, -0.6], [0.3, -0.5, 1.0])}


@pytest.mark.card
@pytest.mark.parametrize("where", sorted(CASES))
def test_counted_jumps_equal_plain_on_the_card(where, card):
    """K1's counting forms with the combined table on the card, against
    the plain version: every result field and every visit equal, counts
    and flags in both restart forms, then the shadow pass's counts, on the
    depth-8 shell and on two malformed pools."""
    import numpy as np

    from octree_tracer_tpu_torch import scenes, state
    from octree_tracer_tpu_torch.render import camera, skip, tracer

    pool, levels, pos, look = CASES[where]
    w = scenes.deep_shell(8) if pool == "shell" else scenes.malformed_pools()[pool]
    words = state.u32_to_device(w, card)
    table = skip.build_warp_skip_table(words, levels)
    _, ci = camera.camera_matrices(np.asarray(pos, np.float32), np.asarray(look, np.float32),
                                   70.0, W, H)
    origin, dirs = camera.generate_rays_device(ci, W, H, card)
    flat = dirs.reshape(-1, 3)
    origins = origin.reshape(1, 3).expand(flat.shape[0], 3)
    for restart in (True, False):
        kw = dict(warp_table=table, parent_restart=restart)
        for flags in (False, True):
            got = torch.zeros(words.shape[0], dtype=torch.int32, device=card)
            want = torch.zeros_like(got)
            res = tracer.trace(words, origins, dirs, visits=got, visit_flags=flags, **kw)
            plain = tracer.trace_plain(words, origins, flat, visits=want, visit_flags=flags,
                                       **kw)
            for a, b in zip(res, plain):
                assert torch.equal(a, b)
            assert torch.equal(got, want), (where, restart, flags)
        got = torch.zeros_like(got)
        want = torch.zeros_like(got)
        hit = tracer.trace_shadow(words, res, cull=False, visits=got, image_width=W, **kw)
        plain = tracer.trace_plain(words, *tracer.shadow_rays(res, cull=False), visits=want,
                                   **kw)
        assert torch.equal(hit, plain.hit) and torch.equal(got, want), (where, restart)
        assert bool(hit.any())
