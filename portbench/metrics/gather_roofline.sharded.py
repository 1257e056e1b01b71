"""The gather's share of its NVLink bound (%): the bytes a rank must
receive for the whole frame (``yardstick.gather_frame_bytes``) at NVLink's
peak a direction, over ``gather_ms.sharded``."""
from portbench import readers, yardstick


def read(run):
    t = readers.rank_kernel_s(run, readers.ALL_GATHER)
    if t is None:
        return None
    return readers.roofline_pct(run.gather_bytes / yardstick.NVLINK_BYTES_PER_S, min(t))
