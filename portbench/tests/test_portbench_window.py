"""The window's arithmetic: a rate over the whole window and every
operation in it, and a 95th percentile over every step that moves when one
step stalls."""

import time
from types import SimpleNamespace

from portbench import harness, yardstick


def fake_run(driver, durations, gap=0.0):
    w = yardstick.Window(1.0)
    t = 100.0
    w.start = t
    for d in durations:
        w.spans.append((t, t + d))
        t += d + gap
    w.end = w.spans[-1][1]
    return SimpleNamespace(traffic={"driver": driver}, window=w, trace=None, setup_s=1.5,
                           settings={"scene": "shell"})


def test_rate_is_the_whole_window_over_the_ops():
    run = fake_run("orbit", [0.001] * 10, gap=0.0005)
    # 10 ops of 1 ms with 0.5 ms between: the window is 14.5 ms long.
    assert abs(harness.reader("frame_ms")(run) - 1.45) < 1e-9
    assert harness.reader("step_ms")(run) is None


def test_step_rate_counts_a_stall():
    calm = fake_run("fly", [0.05] * 100)
    stalled = fake_run("fly", [0.05] * 99 + [1.05])
    assert abs(harness.reader("step_ms")(calm) - 50.0) < 1e-9
    assert abs(harness.reader("step_ms")(stalled) - 60.0) < 1e-9


def test_p95_moves_when_steps_stall():
    calm = fake_run("fly", [0.05] * 100)
    assert abs(harness.reader("step_p95_ms.fly")(calm) - 50.0) < 1e-9
    # Of 20 steps, the slowest lies beyond the 95th percentile's order
    # statistic: one stall moves it.
    one = fake_run("fly", [0.05] * 19 + [1.0])
    assert abs(harness.reader("step_p95_ms.fly")(one) - (50.0 + 0.05 * 950.0)) < 1e-6
    six = fake_run("fly", [0.05] * 94 + [1.0] * 6)
    assert abs(harness.reader("step_p95_ms.fly")(six) - 1000.0) < 1e-9


def test_window_runs_until_the_deadline():
    w = yardstick.Window(0.05)
    seen = []

    def op(i):
        seen.append(i)
        time.sleep(0.004)

    w.run(op)
    assert seen == list(range(w.count))
    assert w.length >= 0.05 and w.spans[-2][1] < w.start + 0.05 <= w.spans[-1][1]
    assert harness.reader("setup_s")(fake_run("orbit", [1.0])) == 1.5
