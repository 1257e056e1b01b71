"""The 95th percentile of the host time of every Session step in the window
(ms), a traced run's."""
from portbench import readers


def read(run):
    if run.traffic["driver"] != "fly" or not run.window.count:
        return None
    return 1e3 * readers.p95(run.window.durations())
