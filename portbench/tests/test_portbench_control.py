"""The control (the reference put in the program's place, in bfloat16)
fails each cell's check at a size a test run holds, while the program
passes it in the same run."""

import time

import pytest
import torch

from portbench import control, harness


@pytest.mark.parametrize("cell", ["shell10-orbit", "island9-fly-noskip", "shell10-fly-noskip"])
def test_control_fails_the_check(cell, tiny):
    spec = tiny(cell)
    run = harness.execute(spec, 4242, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert all(v <= lim for v, lim in run.checks.values()), run.checks
    low = control.control(run)
    assert any(low[name] > run.checks[name][1] for name in low), low


def test_packed_from_takes_the_first_slots():
    sub = torch.tensor([False, True, True, False, True])
    unsub = torch.tensor([True, False, False, False, False])
    assert control.packed_from(sub, unsub, (2, 2)).tolist() == [3, 1, 1, 2, 0, -1]
