"""ms a Session step: the whole window over the steps completed in it."""
from portbench import readers


def read(run):
    return readers.ms_per_op(run, "step")
