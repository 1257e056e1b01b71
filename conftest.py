"""Torch on one intra-op thread in every test process, as ``portbench/run.py``
runs the port: the suite runs several xdist workers on a shared machine, and
the port's plain CPU paths are many small tensor ops, which a per-core
thread pool in each worker only slows. The environment carries the choice to
the processes the tests start."""

import os

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)
