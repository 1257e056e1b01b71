"""What the metric readers (``metrics/<name>.py``) share: a rate over the
whole window, the device's idle share and kernel time from a traced run."""

from __future__ import annotations

import importlib
import re

from . import yardstick


def ms_per_op(run, op: str):
    """Milliseconds of the whole window over the operations completed in
    it, for a run whose driver times ``op``s (its ``Run.OP``: ``"frame"``,
    ``"step"``)."""
    driver = importlib.import_module("portbench.drivers." + run.traffic["driver"])
    if driver.Run.OP != op or not run.window or not run.window.count:
        return None
    return 1e3 * run.window.length / run.window.count


def idle_pct(run, driver: str):
    """100 x (1 - busy / window) of the traced stretch, for ``driver``."""
    if run.traffic["driver"] != driver or not run.trace or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def kernel_s(run, pattern: str):
    """Device seconds an operation of the traced stretch, summed over the
    kernels whose name matches ``pattern``; None where none ran."""
    return trace_kernel_s(run.trace, pattern) if run.trace else None


def trace_kernel_s(trace: dict, pattern: str):
    """``kernel_s`` of one traced stretch."""
    t = sum(v for k, v in trace["by_name"].items() if re.search(pattern, k))
    return t / trace["ops"] if t > 0 else None


def rank_kernel_s(run, pattern: str):
    """``kernel_s`` on each rank of a traced run of several ranks, in rank
    order (``run.rank_traces``); None where a rank ran no such kernel."""
    if not getattr(run, "rank_traces", None):
        return None
    out = [trace_kernel_s(t, pattern) for t in run.rank_traces]
    return None if None in out else out


def span_ms(run, name: str):
    """Mean host milliseconds of the window's ``name`` spans (traced runs)."""
    spans = getattr(run, "spans", {}).get(name) if run.trace else None
    return 1e3 * sum(spans) / len(spans) if spans else None


def roofline_pct(bound_s: float, t_s):
    return None if t_s is None else 100.0 * bound_s / t_s


K1 = r"\btrace_(start_|seed_)?kernel\b"
# NCCL's all-gather kernels (``ncclDevKernel_AllGather_*``, ``ncclKernel_AllGather_*``).
ALL_GATHER = r"AllGather"
p95 = yardstick.p95
