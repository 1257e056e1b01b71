"""K1 device ms a frame (primary pass and shadow mode), from the profiler."""
from portbench import readers


def read(run):
    t = readers.kernel_s(run, readers.K1) if run.traffic["driver"] == "orbit" else None
    return None if t is None else 1e3 * t
