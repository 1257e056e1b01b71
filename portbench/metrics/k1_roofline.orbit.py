"""K1 share of its byte bound (%): the bound of a frame's K1 bytes at the
card's peak bandwidth over K1's device time a frame."""
from portbench import readers, yardstick


def read(run):
    if run.traffic["driver"] != "orbit":
        return None
    return readers.roofline_pct(yardstick.bound_s(run.k1_bytes), readers.kernel_s(run, readers.K1))
