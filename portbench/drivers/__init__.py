"""The drivers of the benchmark's traffic: ``orbit`` (frames of a static
scene), ``sharded`` (the same frames with their rows sharded over cards)
and ``fly`` (Session steps over a streaming world). A traffic file
names its driver; each driver's ``Run`` sets up, measures a window,
optionally profiles, releases the program's state and checks what the
window produced."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import traffic

_LIMITS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "limits")


class Base:
    """What every driver's run holds: the cell's spec, the seed, the device,
    counts and timings for the metric readers, and the checks."""

    # What one timed operation is ("frame", "step"): the end-to-end readers
    # of a rate take a driver's window by it, not by the driver's name.
    OP: str | None = None

    def __init__(self, spec: dict, seed: int, device):
        self.spec = spec
        self.name = spec["cell"]["name"]
        self.settings = spec["settings"]
        self.traffic = spec["traffic"]
        self.seed = seed
        self.device = torch.device(device)
        self.attempted = 0
        self.failed = 0
        self.window = None
        self.trace = None
        self.setup_s = 0.0
        self.memory_peak_bytes = 0
        self.checks: dict = {}

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.on_card else 0

    def limits(self) -> dict:
        """The cell's limit for each number checked."""
        with open(os.path.join(_LIMITS, self.name + ".json")) as f:
            return json.load(f)

    def sample(self, below: int, count: int) -> list[int]:
        """``count`` distinct operation indices below ``below``, from the
        seed: the operations whose outputs are checked besides the last."""
        g = traffic.rng(self.seed, "sample")
        return sorted(int(i) for i in g.choice(below, size=count, replace=False))

    @staticmethod
    def percent(part: float, whole: float) -> float:
        return 100.0 * part / whole if whole else (0.0 if not part else float("inf"))

    def free_cache(self) -> None:
        if self.on_card:
            torch.cuda.empty_cache()


def pose_array(p) -> np.ndarray:
    return np.asarray(p, dtype=np.float32)
