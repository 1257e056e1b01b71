"""100 x subdivisions applied (``engine.subdivided``) over the candidates read
(``engine.sub_read``, before the stale drop), from the program's counters (%)."""
from portbench import spans


def read(run):
    return spans.count_ratio_pct(run, "fly", "engine.subdivided", "engine.sub_read")
