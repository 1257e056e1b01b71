"""Host ms a step in ``session.update`` that none of its child spans covers:
what no span explains."""
from portbench import spans


def read(run):
    return spans.self_ms(run, "fly", "session.update")
