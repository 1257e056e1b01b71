"""What the readers of the program's spans and counters share: the records
of a traced run (``octree_tracer_tpu_torch.utils.timing.records()``, which
fill only while ``torch.profiler`` records, so they cover the profiled
stretch), summed and divided by the stretch's operations.

A program without those records (one older than its spans) gives None, as
does an untraced run or a run of another driver."""

from __future__ import annotations


def program_records(run, driver: str):
    """(spans, counts) the program recorded over the traced stretch of a
    ``driver`` run, or None: the store holds the latest profiler session's
    records alone. A span has ``name``, ``id``, ``parent``, ``start_ns`` and
    ``end_ns``; a count ``name`` and ``n``."""
    if run.traffic["driver"] != driver or not run.trace:
        return None
    try:
        from octree_tracer_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "records", None)
    if read is None:
        return None
    records = read()
    return ([r for r in records if hasattr(r, "end_ns")],
            [r for r in records if hasattr(r, "n")])


def _ms(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a >= end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def span_ms(run, driver: str, *names: str):
    """Host milliseconds an operation in the spans named ``names``; None
    where none was recorded."""
    got = program_records(run, driver)
    if got is None:
        return None
    spans = [s for s in got[0] if s.name in names]
    return _ms(spans) / run.trace["ops"] if spans else None


def self_ms(run, driver: str, name: str):
    """Milliseconds an operation in ``name`` spans that none of their
    children covers: each span less the union of its children's
    intervals."""
    got = program_records(run, driver)
    if got is None:
        return None
    spans = got[0]
    outer = [s for s in spans if s.name == name]
    if not outer:
        return None
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    ns = sum(s.end_ns - s.start_ns - union_ns(children.get(s.id, ())) for s in outer)
    return ns * 1e-6 / run.trace["ops"]


def count_ratio_pct(run, driver: str, part: str, whole: str):
    """100 x the summed counter ``part`` over the summed counter ``whole``;
    None where ``whole`` sums to 0."""
    got = program_records(run, driver)
    if got is None:
        return None
    den = sum(c.n for c in got[1] if c.name == whole)
    return 100.0 * sum(c.n for c in got[1] if c.name == part) / den if den else None
