"""Utilities: timing and profiling instrumentation."""

from .timing import FrameTimer, timed, torch_trace

__all__ = ["FrameTimer", "timed", "torch_trace"]
