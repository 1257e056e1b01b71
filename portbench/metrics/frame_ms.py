"""ms a frame: the whole window over the frames completed in it."""
from portbench import readers


def read(run):
    return readers.ms_per_op(run, "frame")
