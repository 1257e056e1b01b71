"""Performance instrumentation: frame timer, wall timer and a profiler trace
(the JAX package's ``utils/timing.py``; ``torch_trace`` takes the place of
its ``xla_trace``, which wraps ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time


class FrameTimer:
    """Rolling FPS/frame-time tracker (reference: src/app.rs:123-130)."""

    def __init__(self, window: int = 30):
        self.window = window
        self._times: list[float] = []

    def tick(self) -> float:
        """Record a frame boundary; returns instantaneous FPS (0 on first)."""
        now = time.perf_counter()
        self._times.append(now)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[-2]
        return 1.0 / dt if dt > 0 else 0.0

    @property
    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else 0.0


@contextlib.contextmanager
def torch_trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace (host and, where there is one, the
    card's kernels) around a block and write it as a Chrome trace
    ``trace_<pid>_<ns>.json`` under ``log_dir`` (default ``ot_tpu_trace``
    in the temporary directory, where ``xla_trace`` writes); yields
    ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "ot_tpu_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.perf_counter_ns()}.json"))


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
