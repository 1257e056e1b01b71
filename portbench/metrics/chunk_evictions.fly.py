"""Chunks evicted a second of the window (evictions/s)."""


def read(run):
    if run.traffic["driver"] != "fly" or run.settings["scene"] != "island" or not run.trace:
        return None
    return run.window_stream["chunk_evictions"] / run.window.length
