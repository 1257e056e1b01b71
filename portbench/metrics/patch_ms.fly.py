"""Host ms a step in ``session.patches`` (drain, scatter or full upload, the
warp table's invalidation), from the program's spans."""
from portbench import spans


def read(run):
    return spans.span_ms(run, "fly", "session.patches")
