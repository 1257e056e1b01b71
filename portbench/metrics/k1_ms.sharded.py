"""K1 device ms a frame (primary pass and shadow mode) on the slowest rank,
whose block of rows sets the pace of every rank's gather."""
from portbench import readers


def read(run):
    t = readers.rank_kernel_s(run, readers.K1)
    return None if t is None else 1e3 * max(t)
