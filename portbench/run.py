#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell on the
card, from the root of a checkout.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``: each number compared beside its limit), and the checks as the
last lines of standard error. See ``harness.py``."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# One process with few threads: the host's share of a step stays steady on
# a machine whose cores other work shares.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
