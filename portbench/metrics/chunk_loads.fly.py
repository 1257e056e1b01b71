"""Chunks loaded a second of the window (loads/s)."""


def read(run):
    if run.traffic["driver"] != "fly" or run.settings["scene"] != "island" or not run.trace:
        return None
    return run.window_stream["chunk_loads"] / run.window.length
