"""Performance instrumentation: frame timer, wall timer, a profiler trace
(the JAX package's ``utils/timing.py``; ``torch_trace`` takes the place of
its ``xla_trace``, which wraps ``jax.profiler``), and the program's spans
and counters.

Spans and counters record only while a ``torch.profiler`` session records
(``torch_trace``, or any ``torch.profiler.profile``). Then each ``span``
enters ``torch.profiler.record_function``, so it shows in the profiler's
trace on the device trace's clock, and each span and ``count`` appends a
record to a bounded in-memory store (``records()``), which every profiler
session starts empty. Otherwise ``span`` returns a shared no-op context and
``count`` returns at once: no ``record_function``, no allocation, no clock
read.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler


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
    ``log_dir``. The trace carries the program's spans recorded on the
    calling thread; ``records()`` holds every thread's spans and counters
    of the block (the store is cleared on entry, as at the start of any
    profiler session)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    clear()
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


STORE_LIMIT = 65536  # records the store holds; later ones are counted as dropped


class Span(NamedTuple):
    """A closed span: ``parent`` is the ``id`` of the span open around it on
    the same thread (None for a root), ``step`` the ``id`` of its root (or
    the step the caller named), times from ``time.perf_counter_ns``."""
    name: str
    id: int
    parent: int | None
    thread: int
    step: int
    start_ns: int
    end_ns: int


class Count(NamedTuple):
    """A counter increment, with the step of the span open around it."""
    name: str
    n: int
    step: int | None


_store: list = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _append(record) -> None:
    global _dropped
    with _lock:
        if len(_store) < STORE_LIMIT:
            _store.append(record)
        else:
            _dropped += 1


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The shared span of an untraced call."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "step", "id", "parent", "start", "rf")

    def __init__(self, name: str, step: int | None):
        self.name, self.step = name, step

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        if self.step is None:
            self.step = outer.step if outer else self.id
        stack.append(self)
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        _append(Span(self.name, self.id, self.parent, threading.get_ident(), self.step,
                     self.start, end))
        return False


def span(name: str, step: int | None = None):
    """A context manager that records the block as span ``name`` while a
    profiler records. ``step`` names the step the work belongs to, for work
    done on another thread on a step's behalf (``current_step()`` read where
    it was requested); by default a span takes its enclosing span's step,
    and a root span opens a step of its own."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, step)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    _append(Count(name, int(n), current_step()))


def current_step() -> int | None:
    """The step of the innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1].step if stack else None


def records() -> list:
    """The stored ``Span`` and ``Count`` records, oldest first (a span is
    stored when it closes)."""
    with _lock:
        return list(_store)


def dropped() -> int:
    """Records the store turned away since it was last cleared."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0


def _clear_on_profiler_start() -> None:
    """Wrap the hook ``torch.autograd.profiler`` runs as a session starts
    (where it sets the flag ``span`` reads) so that it also clears the
    store: ``records()`` then hold the latest session's records alone, in a
    process that profiles several stretches. A torch without the hook keeps
    the store until ``clear()``."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None:
        return

    def run_on_profiler_start():
        start()
        clear()

    _profiler._run_on_profiler_start = run_on_profiler_start


_clear_on_profiler_start()
