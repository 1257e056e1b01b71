"""The seeded traffic repeats exactly from --seed, and differs between
seeds."""

import numpy as np
import pytest

from portbench import harness, traffic

SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]
ORBIT = harness.cell_spec(harness.benchmark(), "shell10-orbit")["traffic"]
FLY = [harness.cell_spec(harness.benchmark(), c)["traffic"]
       for c in ("island9-fly-noskip", "shell10-fly-noskip")]
# The steps a run_seconds window held, fewest and most (PERF.md, section 4).
WINDOW_STEPS = {"island9-fly-noskip": (280, 345), "shell10-fly-noskip": (270, 305)}


@pytest.mark.parametrize("seed", SEEDS)
def test_orbit_poses_repeat(seed):
    a, b = traffic.orbit_poses(seed, ORBIT), traffic.orbit_poses(seed, ORBIT)
    assert len(a) == ORBIT["poses"]
    for (pa, la), (pb, lb) in zip(a, b):
        assert np.array_equal(pa, pb) and np.array_equal(la, lb)
    for p, look in a:
        r = float(np.linalg.norm(p))
        assert ORBIT["radius"][0] - 1e-5 <= r <= ORBIT["radius"][1] + 1e-5
        aim = p + look  # the point looked at: the centre within the jitter
        assert np.all(np.abs(aim) <= ORBIT["jitter"] + 1e-5)


def test_orbit_poses_are_one_set_in_seeded_orders():
    a, b = traffic.orbit_poses(1, ORBIT), traffic.orbit_poses(2, ORBIT)
    assert not np.array_equal(a[0][0], b[0][0])
    key = lambda poses: sorted(tuple(p) + tuple(look) for p, look in poses)  # noqa: E731
    assert key(a) == key(b)


@pytest.mark.parametrize("p", FLY, ids=["island", "shell"])
@pytest.mark.parametrize("seed", SEEDS)
def test_flight_repeats_step_for_step(p, seed):
    a, b = traffic.Flight(seed, p, 0.05), traffic.Flight(seed, p, 0.05)
    assert np.array_equal(a.pose()[0], traffic.waypoints(seed, p)[0].astype(np.float32))
    prev = a.pos.copy()
    for _ in range(200):
        (pa, la), (pb, lb) = a.advance(), b.advance()
        assert np.array_equal(pa, pb) and np.array_equal(la, lb)
        assert np.linalg.norm(pa - prev) <= 0.05 + 1e-5
        prev = pa.astype(np.float64)
    assert a.k >= 2  # it reached a waypoint and turned to the next


@pytest.mark.parametrize("p", FLY, ids=["island", "shell"])
def test_waypoints_circle_the_centre(p):
    pts = traffic.waypoints(11, p)
    assert pts.shape == (p["waypoints"], 3)
    r = np.hypot(pts[:, 0], pts[:, 2])
    radii = np.asarray([p["radii"][k % len(p["radii"])] for k in range(p["waypoints"])])
    assert np.all(np.abs(r - radii) <= p["radius_jitter"] + 1e-9)
    other = traffic.waypoints(12, p)
    assert not np.array_equal(pts, other)  # the jitter is the seed's
    assert np.abs(pts - other).max() <= 2 * max(p["radius_jitter"], p["height_jitter"]) + 1e-9


def fly_window(p, seed, steps):
    """The poses of a window of ``steps`` steps at the Session's speed."""
    flight = traffic.Flight(seed, p, float(np.exp(-5.0)))
    poses = [flight.pose()] + [flight.advance() for _ in range(steps)]
    return flight, np.array([q for q, _ in poses], np.float64), np.array([v for _, v in poses])


def quadrant(q):
    return (int(q[0] >= 0), int(q[2] >= 0))


def lap(p, seed):
    pts = traffic.waypoints(seed, p)
    return float(np.linalg.norm(np.roll(pts, -1, axis=0) - pts, axis=1).sum())


@pytest.mark.parametrize("seed", SEEDS)
def test_island_window_flies_about_a_lap(seed):
    # A window holds 280-345 steps (PERF.md, section 4): most of a lap or
    # a little more, on a loop of 32 waypoints at r 0.35 and 0.425 up (the
    # island's top is at 0.18), from waypoint 0 over all four quadrants,
    # turning 11.25 degrees at each waypoint, looking ahead and down.
    p = FLY[0]
    lo, hi = WINDOW_STEPS["island9-fly-noskip"]
    for steps in (lo, hi):
        flight, pos, look = fly_window(p, seed, steps)
        r = np.hypot(pos[:, 0], pos[:, 2])
        assert np.all((r > 0.34) & (r < 0.36))
        assert np.all((pos[:, 1] > 0.42) & (pos[:, 1] < 0.43))
        assert {quadrant(q) for q in pos} == {(0, 0), (0, 1), (1, 0), (1, 1)}
        assert 0.75 <= flight.flown / lap(p, seed) <= 1.1
        assert 24 <= flight.k - 1 <= 34
        pitch = np.degrees(np.arcsin(-look[:, 1] / np.linalg.norm(look, axis=1)))
        assert np.allclose(pitch, p["pitch_deg"], atol=1e-3)


@pytest.mark.parametrize("seed", SEEDS)
def test_shell_window_flies_in_from_far_outside_the_shell(seed):
    # A window holds 270-305 steps (PERF.md, section 4): from waypoint 0 at
    # 2.3 units in to waypoint 1 at 1.3, about an eighth of the lap, never
    # within 1.2 units of the centre (the shell's radius is 0.95), looking
    # at the centre. Every run flies this same stretch.
    p = FLY[1]
    lo, hi = WINDOW_STEPS["shell10-fly-noskip"]
    for steps in (lo, hi):
        flight, pos, look = fly_window(p, seed, steps)
        r = np.hypot(pos[:, 0], pos[:, 2])
        assert np.all((r >= 1.2) & (r <= 2.4)) and np.linalg.norm(pos, axis=1).min() >= 1.2
        assert r[0] > 2.19 and r[-1] < 1.45
        assert 0.1 <= flight.flown / lap(p, seed) <= 0.15
        assert np.abs(pos + look).max() <= p["look_jitter"] + 1e-5


def test_island_waypoints_fill_the_quadrants():
    p = FLY[0]
    for seed in SEEDS:
        pts = traffic.waypoints(seed, p)
        assert sorted(quadrant(q) for q in pts) == sorted([(0, 0), (0, 1), (1, 0), (1, 1)]
                                                           * (p["waypoints"] // 4))
