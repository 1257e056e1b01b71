"""Tests of the benchmark harness. They run on the CPU at tiny sizes, with
the program's plain versions; tests that need a CUDA card take the ``card``
fixture, which skips them without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    """A TMPDIR of each test's own: runs write their worlds to a fixed
    directory under it, which tests run side by side must not share."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


TINY = {"shell": {"depth": 6, "width": 64, "height": 36, "warp_levels": 3},
        "island": {"chunk_depth": 4, "width": 64, "height": 36}}


def tiny_spec(workload: str, bench: dict | None = None) -> dict:
    """The cell's spec (of ``bench``, BENCHMARK.json by default) at a size
    the CPU runs in a second or two: a depth-6 shell or a chunk_depth-4
    island at 64x36, few warm steps."""
    from portbench import harness

    spec = harness.cell_spec(bench or harness.benchmark(), workload)
    spec["settings"].update(TINY[spec["settings"]["scene"]])
    # Eight warm steps: the island's flight starts inside the world cube,
    # whose octant leaves every ray hits until the steps split them.
    spec["traffic"].update(warm_steps=8, warm_frames=1, sample_below=4, profile_ops=2)
    return spec


@pytest.fixture
def tiny():
    return tiny_spec
