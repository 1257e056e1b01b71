"""Each cell at its own size on the card, briefly: correct, with every
end-to-end and per-layer metric it names. Run on a machine with a CUDA
card: ``python -m pytest portbench/tests -m card``."""

import time

import pytest
import torch

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace, card):
    spec = harness.cell_spec(harness.benchmark(), cell)
    chips = spec["cell"]["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    run = harness.execute(spec, 2**31 + 5, 2.0, trace, card, time.perf_counter())
    line = harness.result_line(spec, run, trace, harness.device_info(torch, chips))
    assert line["correct"], line["checks"]
    names = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}
    assert set(line["metrics"]) == names
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
