"""Whole runs of each cell on the CPU at a tiny size, past the harness's
look for a card: sound, they come out correct; with the timed path broken
underneath, correct comes out false, once for each fault the cell can have
(one chip each, so no exchange between chips to leave out)."""

import time

import pytest
import torch

from portbench import harness

CPU = torch.device("cpu")
FLY = ["island9-fly-noskip", "shell10-fly-noskip"]


def run_cell(spec, seconds=0.6):
    run = harness.execute(spec, 2**31 + 77, seconds, False, CPU, time.perf_counter())
    return harness.result_line(spec, run, False, {"platform": "cpu", "kind": "cpu", "count": 1})


def alter_frame(render_frame):
    """An answer altered where it is produced: every 5th pixel's red."""
    def broken(*a, **k):
        img, res, visits = render_frame(*a, **k)
        img = img.clone()
        img.view(-1, 3)[::5, 0] ^= 0x40
        return img, res, visits
    return broken


def half_frame(render_frame):
    """Half of the batch left out: the lower half of the rows never traced
    (misses, sky)."""
    def broken(words, origin, dirs, *a, **k):
        img, res, visits = render_frame(words, origin, dirs, *a, **k)
        n = res.hit.shape[0] // 2
        img = img.clone()
        img.view(-1, 3)[n:] = img.view(-1, 3)[0] * 0 + 124
        res = res._replace(hit=torch.cat([res.hit[:n], torch.zeros_like(res.hit[n:])]),
                           index=torch.cat([res.index[:n], torch.full_like(res.index[n:], -1)]))
        return img, res, visits
    return broken


@pytest.mark.parametrize("cell", ["shell10-orbit", "island9-fly-noskip", "shell10-fly-noskip"])
def test_sound_run_is_correct(cell, tiny):
    line = run_cell(tiny(cell))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", ["shell10-orbit", "island9-fly-noskip", "shell10-fly-noskip"])
@pytest.mark.parametrize("fault", [alter_frame, half_frame], ids=["altered", "half"])
def test_broken_frames_are_caught(cell, fault, tiny, monkeypatch):
    from octree_tracer_tpu_torch.render import tracer

    monkeypatch.setattr(tracer, "render_frame", fault(tracer.render_frame))
    line = run_cell(tiny(cell))
    assert not line["correct"] and line["checks"]["frame_diff_pct"]["value"] > 5


@pytest.mark.parametrize("cell", FLY)
def test_step_that_leaves_the_state_unchanged_is_caught(cell, tiny, monkeypatch):
    from octree_tracer_tpu_torch.app.session import Session

    def frozen(self):
        self._last_visits = None
        self.frame_count += 1
        return {"subdivided": 0, "collapsed": 0, "patched": 0}

    monkeypatch.setattr(Session, "update", frozen)
    line = run_cell(tiny(cell))
    assert not line["correct"] and line["checks"]["candidate_diff_pct"]["value"] >= 100


@pytest.mark.parametrize("cell", FLY)
def test_altered_candidates_are_caught(cell, tiny, monkeypatch):
    from octree_tracer_tpu_torch.adaptive import feedback

    select = feedback.select_candidates_packed

    def broken(*a, **k):
        out = select(*a, **k).clone()
        out[0] = out[0] // 2  # half the subdivisions dropped where they are counted
        return out

    monkeypatch.setattr(feedback, "select_candidates_packed", broken)
    line = run_cell(tiny(cell))
    assert not line["correct"] and line["checks"]["candidate_diff_pct"]["value"] > 5


@pytest.mark.parametrize("cell", FLY)
def test_wrong_children_are_caught(cell, tiny, monkeypatch):
    """The engine subdivides into wrong children: every filled child of a
    node it splits takes another colour, in the host octree and so in the
    device pool, so the frames and candidates agree with the pool they read
    and only the walk against the world sees it."""
    from octree_tracer_tpu_torch.adaptive import engine
    from octree_tracer_tpu_torch.app import native_engine
    from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET, leaf_word, word_payload

    def wrong(process):
        def broken(candidates, octree, world):
            first = len(octree._dirty)
            out = process(candidates, octree, world)
            for start, _ in octree._dirty[first:]:
                base = int(word_payload(octree._nodes[start]))
                if base >= VOXEL_OFFSET:
                    continue  # a leaf's slot: a child written, not a node split
                for slot in range(base, base + 8):
                    colour = int(word_payload(octree._nodes[slot])) - VOXEL_OFFSET
                    if colour > 0:
                        octree._nodes[slot] = leaf_word(colour ^ 0x000040)
                        octree._mark(slot, slot + 1)
            return out
        return broken

    monkeypatch.setattr(native_engine, "process_subdivision",
                        wrong(native_engine.process_subdivision))
    monkeypatch.setattr(engine, "process_subdivision", wrong(engine.process_subdivision))
    line = run_cell(tiny(cell))
    checks = line["checks"]
    assert not line["correct"] and checks["pool_world_off"]["value"] > 0
    assert checks["pool_words_off"]["value"] == 0
