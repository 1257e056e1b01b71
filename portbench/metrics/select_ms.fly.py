"""Host ms a step in ``session.select`` (K6 closure, K5, the pinned buffer and
its copy), from the program's spans."""
from portbench import spans


def read(run):
    return spans.span_ms(run, "fly", "session.select")
