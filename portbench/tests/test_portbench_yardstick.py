"""The frozen byte and operation counts against hand counts at small
shapes, and the reading of a profiler trace."""

from types import SimpleNamespace

import torch

from portbench import yardstick


def test_k1_frame_bytes_by_hand():
    # 16 pool words and an 8-word table: 96 B; 2 rays: 12 B of direction,
    # 42 B of result, 25 B read back by the shadow pass, 1 B of shadow hit.
    assert yardstick.k1_frame_bytes(16, 8, 2) == 96 + 2 * (12 + 42 + 25 + 1)
    assert yardstick.k1_frame_bytes(0, 0, 1) == 80


def test_bound_takes_the_larger():
    assert yardstick.bound_s(3.35e12) == 1.0
    assert yardstick.bound_s(3.35e9, 67e12) == 1.0
    assert yardstick.bound_s(0, 67e9) == 1e-3


def ev(name, start, end, cuda):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt,
                           time_range=SimpleNamespace(start=start, end=end))


def test_read_trace_busy_is_the_union_and_gaps_are_named():
    events = [ev("step", 0, 1000, False), ev("render", 0, 300, False),
              ev("update", 300, 900, False),
              ev("k1", 10, 110, True), ev("k4", 100, 150, True),   # overlap: 140 busy
              ev("k5", 700, 760, True)]                            # gap 150-700
    prof = SimpleNamespace(events=lambda: events)
    out = yardstick.read_trace(prof, 1e-3)
    assert abs(out["busy_s"] - 200e-6) < 1e-12
    assert out["window_s"] == 1e-3
    assert out["device_ops"][0][0] == "k1" and abs(out["device_ops"][0][1] - 100e-6) < 1e-12
    [(name, gap)] = out["idle_gaps"]
    assert name == "update" and abs(gap - 550e-6) < 1e-12
