"""Device ms a frame in NCCL's all-gather kernels, the least over the ranks:
the rank that reaches the gather last waits least in it, so its time is
the closest to the transfer alone (a rank that is early spins in the
kernel until the last one arrives)."""
from portbench import readers


def read(run):
    t = readers.rank_kernel_s(run, readers.ALL_GATHER)
    return None if t is None else 1e3 * min(t)
