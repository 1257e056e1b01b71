"""The general traffic generator: camera poses and flight paths drawn from
``--seed`` and a traffic file's parameters. The same seed gives the same
poses and the same path, step for step, on any machine; every seed asks
for the same work (the same poses in another order, the same loop but for
a jitter)."""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use of the seed."""
    return np.random.default_rng([seed % (1 << 64), *stream.encode()])


def orbit_poses(seed: int, p: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    """``p["poses"]`` cameras (position, look direction), the same set for
    every seed, in an order drawn from the seed: at distances spread evenly
    over ``p["radius"]`` from ``p["centre"]``, on a golden-angle spiral of
    elevations within ``p["max_elevation_deg"]``, each looking at the
    centre moved by up to ``p["jitter"]`` on each axis (a fixed jitter of
    the set)."""
    n = p["poses"]
    k = np.arange(n)
    centre = np.asarray(p["centre"], np.float64)
    az = k * np.pi * (3.0 - np.sqrt(5.0))
    el = np.radians(p["max_elevation_deg"]) * ((k + 0.5) / n * 2.0 - 1.0)
    r = p["radius"][0] + (p["radius"][1] - p["radius"][0]) * ((k * 37) % n + 0.5) / n
    jit = rng(0, "orbit jitter").uniform(-p["jitter"], p["jitter"], (n, 3))
    unit = np.stack([np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)], axis=1)
    pos = centre + unit * r[:, None]
    look = centre + jit - pos
    order = rng(seed, "orbit").permutation(n)
    return [(pos[i].astype(np.float32), look[i].astype(np.float32)) for i in order]


def waypoints(seed: int, p: dict) -> np.ndarray:
    """f64[n, 3] of a closed loop around ``p["centre"]``: waypoint k at the
    angle ``start + k * 360 * turns / n`` degrees about the y axis
    (``p["start_angle_deg"]``), at the distance ``p["radii"][k % len]``
    and the height ``p["heights"][k % len]``, each moved by up to
    ``p["radius_jitter"]`` and ``p["height_jitter"]`` drawn from the seed.
    Every seed flies the same loop but for the jitter, so every seed asks
    for about the same work."""
    g = rng(seed, "fly")
    n = p["waypoints"]
    ang = np.radians(p["start_angle_deg"]) + np.arange(n) * 2.0 * np.pi * p["turns"] / n
    r = np.asarray([p["radii"][k % len(p["radii"])] for k in range(n)], np.float64)
    r = r + g.uniform(-p["radius_jitter"], p["radius_jitter"], n)
    h = np.asarray([p["heights"][k % len(p["heights"])] for k in range(n)], np.float64)
    h = h + g.uniform(-p["height_jitter"], p["height_jitter"], n)
    centre = np.asarray(p["centre"], np.float64)
    return centre + np.stack([r * np.sin(ang), h, r * np.cos(ang)], axis=1)


class Flight:
    """The camera of a fly-through along the closed loop ``waypoints(seed,
    p)``: it starts on waypoint 0, and each step moves ``step`` units
    toward the next waypoint, taking the one after once within a step of
    it. ``p["look"]`` says where it looks: ``"centre"``, at ``p["centre"]``
    moved by the next waypoint's jitter of up to ``p["look_jitter"]`` on
    each axis; ``"ahead"``, along its heading toward the next waypoint,
    pitched down by ``p["pitch_deg"]``."""

    def __init__(self, seed: int, p: dict, step: float):
        self.p = p
        self.points = waypoints(seed, p)
        g = rng(seed, "look")
        self.looks = np.asarray(p["centre"], np.float64) + g.uniform(
            -p["look_jitter"], p["look_jitter"], self.points.shape)
        self.pos = self.points[0].copy()
        self.step = step
        self.k = 1  # the waypoint it heads for, counted over laps
        self.flown = 0.0

    def pose(self) -> tuple[np.ndarray, np.ndarray]:
        """The camera's (position, look direction) now, f32."""
        n = self.points.shape[0]
        if self.p["look"] == "ahead":
            heading = self.points[self.k % n] - self.pos
            h = float(np.hypot(heading[0], heading[2]))
            pitch = np.radians(self.p["pitch_deg"])
            look = np.array([heading[0] / h * np.cos(pitch), -np.sin(pitch),
                             heading[2] / h * np.cos(pitch)])
        else:
            look = self.looks[self.k % n] - self.pos
        return self.pos.astype(np.float32), look.astype(np.float32)

    def advance(self) -> tuple[np.ndarray, np.ndarray]:
        """Move one step; the new pose."""
        n = self.points.shape[0]
        to = self.points[self.k % n] - self.pos
        dist = float(np.linalg.norm(to))
        if dist <= self.step:
            self.pos = self.points[self.k % n].copy()
            self.k += 1
            self.flown += dist
        else:
            self.pos = self.pos + to * (self.step / dist)
            self.flown += self.step
        return self.pose()
