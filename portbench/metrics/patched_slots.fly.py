"""Slots the adaptive pass's patch journal drained a step
(``session.patched_slots``), from the program's counters."""
from portbench import spans


def read(run):
    got = spans.program_records(run, "fly")
    if got is None:
        return None
    counts = [c.n for c in got[1] if c.name == "session.patched_slots"]
    return sum(counts) / run.trace["ops"] if counts else None
