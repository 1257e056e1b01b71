"""The reference camera: the upstream viewer's perspective camera
(ria8651/octree-tracer ``src/app.rs`` look-at and projection), its inverse
in float64 rounded to f32, and one primary ray a pixel centre, computed term
by term in f32 (no fused multiply-add), unit length."""

from __future__ import annotations

import numpy as np
import torch


def camera_inverse(pos, look, fov_deg: float, width: int, height: int) -> np.ndarray:
    """f32[4, 4] inverse of projection @ view for a camera at ``pos`` looking
    along ``look`` (up +y), ``fov_deg`` the vertical field of view."""
    eye = np.asarray(pos, dtype=np.float32)
    f = np.asarray(look, dtype=np.float32)
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.array([0.0, 1.0, 0.0], dtype=np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4, dtype=np.float32)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[0, 3], view[1, 3], view[2, 3] = -np.dot(s, eye), -np.dot(u, eye), np.dot(f, eye)
    t = 1.0 / np.tan((fov_deg / 2.0) * (np.pi / 180.0))
    proj = np.diag([height / width * t, t, -1.0, 1.0]).astype(np.float32)
    cam = (proj @ view).astype(np.float32)
    return np.linalg.inv(cam.astype(np.float64)).astype(np.float32)


def primary_rays(ci: np.ndarray, width: int, height: int, device) -> tuple:
    """(origin f32[3], dirs f32[H * W, 3]) in row-major pixel order."""
    c = torch.from_numpy(np.ascontiguousarray(ci, dtype=np.float32)).to(device)
    origin = c[:3, 3] / c[3, 3]
    w = torch.tensor(float(width), device=device)
    h = torch.tensor(float(height), device=device)
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / w * 2.0 - 1.0
    ys = -((torch.arange(height, dtype=torch.float32, device=device) + 0.5) / h * 2.0 - 1.0)
    cx = xs[None, :].expand(height, width).reshape(-1)
    cy = ys[:, None].expand(height, width).reshape(-1)
    world = [((cx * c[j, 0] + cy * c[j, 1]) + c[j, 2]) + c[j, 3] for j in range(4)]
    d = [world[j] / world[3] - origin[j] for j in range(3)]
    norm = torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    return origin, torch.stack([v / norm for v in d], dim=-1)
