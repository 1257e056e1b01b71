"""The share of steps whose frame rode a table with a live skip half (%),
from the counter ``session.skip_live`` (1 for such a frame, 0 for any other,
each frame); None from a program without it."""
from portbench import spans


def read(run):
    got = spans.program_records(run, "fly")
    if got is None:
        return None
    live = [c.n for c in got[1] if c.name == "session.skip_live"]
    return 100.0 * sum(live) / len(live) if live else None
