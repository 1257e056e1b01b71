"""The slowest rank's K1 device time over the ranks' mean (%; 100 is an
even split of K1's work over the row blocks)."""
from portbench import readers


def read(run):
    t = readers.rank_kernel_s(run, readers.K1)
    return None if t is None else 100.0 * max(t) * len(t) / sum(t)
