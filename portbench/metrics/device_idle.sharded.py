"""Rank 0's device idle share of the traced stretch (%). A rank that waits
for the others in a gather is busy: NCCL's kernel spins on the card."""
from portbench import readers


def read(run):
    return readers.idle_pct(run, "sharded")
