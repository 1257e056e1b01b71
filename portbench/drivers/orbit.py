"""Frames of a static scene, one after another: each ray generation and
``render_frame`` (K3, K1 primary, K1 shadow mode, K4) waits for the frame
before it, as a viewer that presents every frame does; the image stays on
the card. The frames ride the combined warp and skip table of the
configuration's level. Poses cycle through a seeded orbit.

Checked: the frames at a few seeded indices and the last one, every pixel
(hit, the hit leaf's slot, the u8 colour) against the reference's frame of
the same pool from the same pose."""

from __future__ import annotations

import numpy as np
import torch

from .. import compare, scenes, traffic, yardstick
from ..reference import trace as ref_trace
from . import Base


class Run(Base):
    OP = "frame"

    def setup(self) -> None:
        from octree_tracer_tpu_torch.render import camera, skip
        from octree_tracer_tpu_torch.state import u32_to_device

        s, t = self.settings, self.traffic
        self.words_np = scenes.pool_words(s)
        self.words = u32_to_device(self.words_np, self.device)
        self.table = skip.build_warp_skip_table(self.words, s["warp_levels"])
        self.poses = traffic.orbit_poses(self.seed, t)
        self.cis = [camera.camera_matrices(p, look, s["fov"], s["width"], s["height"])[1]
                    for p, look in self.poses]
        self.sun = np.asarray(s["sun"], np.float32)
        self.kept: dict = {}
        self.samples = set(self.sample(t["sample_below"], t["samples"]))
        for i in range(t["warm_frames"]):
            self.frame(i)
        self.sync()

    def frame(self, i: int):
        from octree_tracer_tpu_torch.render import camera, tracer

        s = self.settings
        origin, dirs = camera.generate_rays_device(self.cis[i % len(self.cis)], s["width"],
                                                   s["height"], self.device)
        img, res, _ = tracer.render_frame(self.words, origin, dirs, sun_dir=self.sun,
                                          shadows=s["shadows"], warp_table=self.table,
                                          u8_image=s["u8"])
        return img, res

    def measure(self, seconds: float, trace: bool) -> None:
        def op(i):
            img, res = self.frame(i)
            self.sync()
            if i in self.samples:
                self.kept[i] = (img, res.hit, res.index)
            self.last = (i, (img, res.hit, res.index))

        self.window = yardstick.Window(seconds)
        self.window.run(op)
        self.attempted = self.window.count
        i, out = self.last
        self.kept[i] = out
        if trace:
            def traced(i):
                with torch.profiler.record_function("frame"):
                    self.frame(i)
                    self.sync()
            self.trace = yardstick.profile(traced, self.traffic["profile_ops"], self.sync,
                                           ("frame",))
            self.k1_bytes = yardstick.k1_frame_bytes(
                self.words_np.shape[0], int(self.table.shape[0]),
                self.settings["width"] * self.settings["height"])

    def release(self) -> None:
        del self.words, self.table
        self.free_cache()

    def check(self) -> dict:
        words = ref_trace.widen(torch.from_numpy(self.words_np.astype(np.int64)).to(self.device))
        diffs = pixels = 0
        for i, (img, hit, index) in sorted(self.kept.items()):
            pos, look = self.poses[i % len(self.poses)]
            ref = compare.reference_frame(words, pos, look, self.settings, self.device)
            diffs += compare.frame_diffs(img, hit, index, ref)
            pixels += hit.numel()
        lim = self.limits()
        return {"frame_diff_pct": (self.percent(diffs, pixels), lim["frame_diff_pct"])}
