"""What the metric readers (``metrics/<name>.py``) share: a rate over the
whole window, the device's idle share and kernel time from a traced run."""

from __future__ import annotations

import re

from . import yardstick


def ms_per_op(run, driver: str):
    """Milliseconds of the whole window over the operations completed in
    it, for a run of ``driver``."""
    if run.traffic["driver"] != driver or not run.window or not run.window.count:
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
    if not run.trace:
        return None
    t = sum(v for k, v in run.trace["by_name"].items() if re.search(pattern, k))
    return t / run.trace["ops"] if t > 0 else None


def span_ms(run, name: str):
    """Mean host milliseconds of the window's ``name`` spans (traced runs)."""
    spans = getattr(run, "spans", {}).get(name) if run.trace else None
    return 1e3 * sum(spans) / len(spans) if spans else None


def roofline_pct(bound_s: float, t_s):
    return None if t_s is None else 100.0 * bound_s / t_s


K1 = r"\btrace_(start_|seed_)?kernel\b"
p95 = yardstick.p95
