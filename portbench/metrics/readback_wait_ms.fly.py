"""Host ms a step waiting on the previous selection's readback
(``session.readback_wait``), from the program's spans."""
from portbench import spans


def read(run):
    return spans.span_ms(run, "fly", "session.readback_wait")
