"""Skip-half rebuilds a step (counter ``session.skip_rebuilds``, one a
``Session._rebuild_skip_half``); 0 over a traced stretch that rebuilt
nothing. None from a program that does not count its frames' skip halves
(``session.skip_live``)."""
from portbench import spans


def read(run):
    got = spans.program_records(run, "fly")
    if got is None or not any(c.name == "session.skip_live" for c in got[1]):
        return None
    return sum(c.n for c in got[1] if c.name == "session.skip_rebuilds") / run.trace["ops"]
