"""Host ms a step in the adaptive pass's engine (``session.engine``: candidate
slicing, the stale drop, both engine calls), from the program's spans."""
from portbench import spans


def read(run):
    return spans.span_ms(run, "fly", "session.engine")
