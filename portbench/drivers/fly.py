"""Session steps over a streaming world, one after another: a step is
``Session.render()``, ``Session.update()`` and the u8 frame's copy to the
host, which is what a viewer fetches. Chunk files load on the World's IO
pool while the steps go on, as in the viewer. The camera flies a closed
loop of waypoints (``traffic.Flight``), the same for every seed but for a
jitter, at the Session's own speed (``Character.speed``, exp(-5) units a
step); the warm steps stand on the loop's first waypoint.

Checked, at a few seeded steps and the last one:

- the step's frame, every pixel (hit, the hit leaf's slot, the u8 colour
  fetched) against the reference's frame of the pool the step traced;
- the adaptive pass's decision: the program's packed candidate lists (K1's
  visits, K6's closure, K5's selection) against the reference's own rule
  on the pool it selected on, under the visits of the reference's frame;

and, once the window has closed, the device pool word for word against the
host octree that the engine's subdivisions and collapses built, and node
for node against the world (``reference/world.py``): every node reachable
from the root as the engine builds it from the world at its path.

The frame and the candidates follow the program step by step: the
reference judges each step from the pools that step read, which the
program's earlier steps made; the walk against the world checks what
those steps built."""

from __future__ import annotations

import contextlib
import shutil
import time

import numpy as np
import torch

from .. import compare, scenes, traffic, yardstick
from ..reference import select as ref_select
from ..reference import trace as ref_trace
from ..reference import world as ref_world
from . import Base, pose_array

PARTS = ("render", "update", "fetch")


class Run(Base):
    OP = "step"

    def setup(self) -> None:
        from octree_tracer_tpu_torch.app.session import Session

        s, t = self.settings, self.traffic
        self.world, self.world_words = scenes.world(s, self.device)
        self.sess = Session(self.world, s["width"], s["height"], device=self.device)
        self.sess.settings.fov = s["fov"]
        self.sess.settings.sun_dir = pose_array(s["sun"])
        self.sess.settings.shadows = s["shadows"]
        for key, value in s.get("session", {}).items():
            setattr(self.sess.settings, key, value)
        self.flight = traffic.Flight(self.seed, t, float(np.exp(self.sess.character.speed)))
        self.sess.character.pos, self.sess.character.look = self.flight.pose()
        for _ in range(t["warm_steps"]):
            img, _, _ = self.sess.step()
            img.cpu()
        self.world.wait_for_loads()
        self.sync()
        self.samples = set(self.sample(t["sample_below"], t["samples"]))
        self.kept: dict = {}
        self.spans = {k: [] for k in PARTS}
        self.resident = set(self.world.chunks)
        self.loads = self.evictions = 0

    def step(self, i: int, timed: bool, span=contextlib.nullcontext) -> None:
        """One step along the flight; ``timed`` ends the render in a
        synchronise and records each part's host time; ``span(name)``
        wraps each part."""
        sess = self.sess
        sess.character.pos, sess.character.look = self.flight.advance()
        t0 = time.perf_counter()
        with span("render"):
            img, res = sess.render()
            if timed:
                self.sync()
        t1 = time.perf_counter()
        frame_words = sess._frame_words
        with span("update"):
            sess.update()
        t2 = time.perf_counter()
        with span("fetch"):
            host = img.cpu()
        t3 = time.perf_counter()
        if timed:
            for k, v in zip(PARTS, (t1 - t0, t2 - t1, t3 - t2)):
                self.spans[k].append(v)
        resident = set(self.world.chunks)
        self.loads += len(resident - self.resident)
        self.evictions += len(self.resident - resident)
        self.resident = resident
        pending = sess._pending_feedback
        sel = sess.device_words if sess.device_words.shape == frame_words.shape else frame_words
        kept = {"pos": sess.character.pos.copy(), "look": sess.character.look.copy(),
                "words": frame_words, "u8": host, "hit": res.hit, "index": res.index,
                "packed": None if pending is None else pending[0],
                "caps": None if pending is None else pending[4], "sel_words": sel,
                "node_len": min(len(sess.octree), int(sel.shape[0]))}
        if i in self.samples:
            self.kept[i] = kept
        self.last = (i, kept)

    def measure(self, seconds: float, trace: bool) -> None:
        self.window = yardstick.Window(seconds)
        self.window.run(lambda i: self.step(i, trace))
        self.attempted = self.window.count
        self.window_stream = {"chunk_loads": self.loads, "chunk_evictions": self.evictions,
                              "flown": self.flight.flown, "waypoints_passed": self.flight.k - 1}
        self.sync()
        i, kept = self.last
        self.kept[i] = kept
        if trace:
            def traced(i):
                self.step(self.window.count + i, False, torch.profiler.record_function)
            self.trace = yardstick.profile(traced, self.traffic["profile_ops"], self.sync, PARTS)
        from octree_tracer_tpu_torch.state import to_numpy_u32

        self.world.wait_for_loads()
        self.pool = to_numpy_u32(self.sess.device_words)
        nodes = self.sess.octree.nodes
        n = nodes.shape[0]
        self.pool_words_off = (int((self.pool[:n] != nodes).sum())
                               + int(np.count_nonzero(self.pool[n:]))
                               if self.pool.shape[0] >= n else n)

    def release(self) -> None:
        self.world._pool.shutdown(wait=True)
        self.world_path = self.world.path
        del self.sess, self.world
        self.free_cache()

    def world_tree(self) -> dict:
        """The reference's tree of the world the Session streamed from: the
        benchmark's own words, or the chunk files it read."""
        if self.world_words is not None:
            return ref_world.from_words(self.world_words, self.device)
        try:
            return ref_world.from_chunk_files(self.world_path, self.device)
        finally:
            shutil.rmtree(self.world_path, ignore_errors=True)

    def check(self) -> dict:
        diffs = pixels = cand = cand_ref = 0
        ms = sorted(1e3 * d for d in self.window.durations())
        self.details = [{"steps": len(ms), "step_ms_median": ms[len(ms) // 2],
                         "step_ms_slowest": [round(x, 1) for x in ms[-5:]],
                         **self.window_stream}]
        for i, k in sorted(self.kept.items(), key=lambda kv: kv[0]):
            words = ref_trace.widen(k["words"])
            ref = compare.reference_frame(words, k["pos"], k["look"], self.settings,
                                          words.device, with_visits=True)
            d_frame = compare.frame_diffs(k["u8"], k["hit"], k["index"], ref)
            diffs, pixels = diffs + d_frame, pixels + k["hit"].numel()
            detail = {"step": i, "pool_words": int(words.shape[0]), "frame_diffs": d_frame}
            if k["packed"] is None:  # no selection to judge: every candidate is missed
                sub, unsub = ref_select.candidates(ref_trace.widen(k["sel_words"]),
                                                   ref["visits"], k["node_len"])
                n = int(sub.sum() + unsub.sum())
                detail.update(reference=n, diffs=max(n, 1))
            else:
                detail.update(compare.candidate_diffs(
                    k["packed"].numpy(), k["caps"], ref_trace.widen(k["sel_words"]), words,
                    ref["visits"], k["node_len"]))
            cand, cand_ref = cand + detail["diffs"], cand_ref + detail["reference"]
            self.details.append(detail)
        walk = ref_world.pool_off(
            torch.from_numpy(self.pool.astype(np.int64)).to(self.device), self.world_tree())
        self.details.append({"pool_nodes_walked": walk["nodes"], "pool_world_off": walk["off"]})
        lim = self.limits()
        return {"frame_diff_pct": (self.percent(diffs, pixels), lim["frame_diff_pct"]),
                "candidate_diff_pct": (self.percent(cand, cand_ref), lim["candidate_diff_pct"]),
                "pool_words_off": (float(self.pool_words_off), lim["pool_words_off"]),
                "pool_world_off": (float(walk["off"]), lim["pool_world_off"])}
