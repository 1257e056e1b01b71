"""Utilities: timing and profiling instrumentation."""

from .timing import FrameTimer, clear, count, records, span, timed, torch_trace

__all__ = ["FrameTimer", "clear", "count", "records", "span", "timed", "torch_trace"]
