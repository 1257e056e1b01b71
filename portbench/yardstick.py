"""The benchmark's arithmetic, kept apart from the program it measures: the
card's peaks, roofline bounds, the bytes and operations a kernel's work
needs (computed from shapes), percentiles over a window, and the reading of
a ``torch.profiler`` trace (device time by kernel, the device's busy time as
the union of its operations, the longest idle gaps and what the host was
doing in them)."""

from __future__ import annotations

import time

import numpy as np

# One NVIDIA H100 SXM, dense rates, at its full 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# The bytes one ray's primary result takes: hit and forced (1 B each),
# index, steps, depth and the leaf's word (4 B each), hit position and
# normal (12 B each).
RESULT_BYTES = 42
DIR_BYTES = 12
# A u8 pixel.
PIXEL_BYTES = 3
# NVLink 4 of one H100 SXM card, each direction (NVIDIA's data sheet: 900
# GB/s in both together).
NVLINK_BYTES_PER_S = 450e9


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least seconds the card could take to move ``nbytes`` and do
    ``ops`` f32 operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def k1_frame_bytes(pool_words: int, table_words: int, rays: int) -> int:
    """Bytes a shadowed frame's two K1 passes need, each input byte once:
    the pool and the table (4 B a word), 12 B of direction a ray, the
    primary result written once and read by the shadow pass for its rays'
    origins and normals (hit, hit position, normal: 25 B), and the shadow
    hit written (1 B)."""
    return 4 * (pool_words + table_words) + rays * (DIR_BYTES + RESULT_BYTES + 25 + 1)


def gather_frame_bytes(rays: int, ranks: int) -> int:
    """Bytes one rank must receive to hold the whole frame of ``rays`` rays
    sharded over ``ranks``: the other ranks' rays, each a primary result and
    a u8 pixel. It counts what the frame needs, not how a gather packs it."""
    return rays * (ranks - 1) // ranks * (RESULT_BYTES + PIXEL_BYTES)


def p95(values) -> float:
    """The 95th percentile of every value (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


class Window:
    """Times operations run one after another until ``seconds`` have
    passed: each ``(start, end)`` on the host clock. The window runs from
    its start to the end of the last operation, which begins before the
    deadline and is counted whole."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.spans: list[tuple[float, float]] = []
        self.start = self.end = 0.0

    def run(self, op, stop=None) -> None:
        """Call ``op(i)`` for i = 0, 1, ... until the deadline. Given
        ``stop``, the window ends after the first operation i for which
        ``stop(i, due)`` is true, ``due`` saying whether operation i ended
        past the deadline: processes that run one window together end it
        where they agree."""
        self.start = time.perf_counter()
        deadline = self.start + self.seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            op(i)
            t1 = time.perf_counter()
            self.spans.append((t0, t1))
            due = t1 >= deadline
            if stop(i, due) if stop else due:
                break
            i += 1
        self.end = self.spans[-1][1]

    @property
    def length(self) -> float:
        return self.end - self.start

    @property
    def count(self) -> int:
        return len(self.spans)

    def durations(self) -> list[float]:
        return [b - a for a, b in self.spans]


def _device_events(prof, labels):
    """The device's operations: kernels, copies and sets, not the device
    side of the harness's own spans (``labels``)."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in labels]


def read_trace(prof, t_window: float, labels=()) -> dict:
    """What a profiler trace says of the device over a window of
    ``t_window`` host seconds: seconds by operation name, busy seconds (the
    union of every device operation's interval), and the longest idle gaps
    between operations, each named by the innermost host span or operation
    open at the gap's middle. ``labels`` are the harness's span names."""
    dev = _device_events(prof, labels)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    busy, end, gaps = 0.0, None, []
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        busy += max(b - max(a, end if end is not None else a), 0.0)
        end = b if end is None else max(end, b)
    host = [e for e in prof.events() if dev and e.device_type != dev[0].device_type]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        inner = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = min(inner, key=lambda e: e.time_range.end - e.time_range.start).name \
            if inner else "no host operation"
        named.append([name, (b - a) * 1e-6])
    return {"by_name": by_name, "busy_s": busy * 1e-6, "window_s": t_window,
            "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": named}


def profile(op, count: int, sync, labels=(), start=None) -> dict:
    """Run ``op(i)`` for i < ``count`` under ``torch.profiler`` (host and
    device activity), ending in ``sync()``, and read the trace; ``labels``
    are the names of the spans ``op`` records. ``start()``, given, runs
    under the profiler before the first operation and the window's start."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if start:
            start()
        t0 = time.perf_counter()
        for i in range(count):
            op(i)
        sync()
        t_window = time.perf_counter() - t0
    out = read_trace(prof, t_window, labels)
    out["ops"] = count
    return out
