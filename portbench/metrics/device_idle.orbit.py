"""The device's idle share of the traced stretch (%)."""
from portbench import readers


def read(run):
    return readers.idle_pct(run, "orbit")
