"""Host ms a step in ``session.engine`` outside the native library's calls
(``engine.native``): the Python around the engine, from the program's spans."""
from portbench import spans


def read(run):
    engine = spans.span_ms(run, "fly", "session.engine")
    if engine is None:
        return None
    return engine - (spans.span_ms(run, "fly", "engine.native") or 0.0)
