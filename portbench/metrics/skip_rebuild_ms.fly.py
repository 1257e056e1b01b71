"""Host ms a step in ``session.skip_rebuild``, the skip half's host rebuild
after a collapse batch (K2's occupancy copied to the host, then NumPy), from
the program's spans; 0 over a traced stretch that rebuilt nothing. None
from a program that does not count its frames' skip halves
(``session.skip_live``)."""
from portbench import spans


def read(run):
    got = spans.program_records(run, "fly")
    if got is None or not any(c.name == "session.skip_live" for c in got[1]):
        return None
    return spans.span_ms(run, "fly", "session.skip_rebuild") or 0.0
