"""Shader math in plain PyTorch: 3-D simplex noise and SDF primitives (the
port of the JAX package's ``gen/noise.py``).

Every function maps over leading batch dimensions with the vector component
on the trailing axis, as the JAX functions do, and repeats their f32
arithmetic operation for operation: each Python constant is rounded to f32 at
its use (JAX's weak typing), a sum over 3 or 4 components runs left to right,
``%`` is a floor-mod, ``sign(0)`` is 0, and a division by a constant divides
(``state.div_scalar``: on the card PyTorch would multiply by a rounded
reciprocal). Kernel K7 (``csrc/block_grid.cu``) evaluates the same
expressions in the same order, so on one device the two agree bit for bit.
XLA's CPU build contracts multiply-adds into FMAs, so JAX's values differ
from these by a few ulps (``tests/test_torch_gen.py`` states the tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import div_scalar

# 1/6 and 1/3 of the noise's skew, and the two multiples of 1/6 that JAX
# folds in double before rounding (``2.0 * Cx``, ``3.0 * Cx``).
CX, CY = 1.0 / 6.0, 1.0 / 3.0
CX2, CX3 = 2.0 * (1.0 / 6.0), 3.0 * (1.0 / 6.0)
# ns = n_ * D.wyz - D.xzx with n_ = 1/7 and D = (0, 0.5, 1, 2), in f32.
_N7 = np.float32(1.0 / 7.0)
NS_X = float(_N7 * np.float32(2.0) - np.float32(0.0))
NS_Y = float(_N7 * np.float32(0.5) - np.float32(1.0))
NS_Z = float(_N7 * np.float32(1.0) - np.float32(0.0))
TAYLOR_A, TAYLOR_B = 1.79284291400159, 0.85373472095314


def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``x % m`` for ``m > 0`` as JAX computes it: the truncated remainder
    (exact), plus ``m`` where it is negative."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def _permute(x):
    return floor_mod((x * 34.0 + 1.0) * x, 289.0)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def simplex_noise3(v: torch.Tensor) -> torch.Tensor:
    """3-D simplex noise; ``v`` is f32[..., 3] -> f32[...]."""
    vx, vy, vz = v.unbind(-1)
    s = (vx + vy + vz) * CY
    i = [torch.floor(vx + s), torch.floor(vy + s), torch.floor(vz + s)]
    t = (i[0] + i[1] + i[2]) * CX
    x0 = [vx - i[0] + t, vy - i[1] + t, vz - i[2] + t]

    # step(x0.yzx, x0.xyz), and its complement rolled to .zxy.
    g = [(x0[k] >= x0[(k + 1) % 3]).to(v.dtype) for k in range(3)]
    lzxy = [1.0 - g[(k + 2) % 3] for k in range(3)]
    i1 = [torch.minimum(g[k], lzxy[k]) for k in range(3)]
    i2 = [torch.maximum(g[k], lzxy[k]) for k in range(3)]
    corners = [
        x0,
        [x0[k] - i1[k] + CX for k in range(3)],
        [x0[k] - i2[k] + CX2 for k in range(3)],
        [x0[k] - 1.0 + CX3 for k in range(3)],
    ]
    i = [floor_mod(c, 289.0) for c in i]
    ones = torch.ones_like(vx)
    offsets = [[torch.zeros_like(vx)] * 3, i1, i2, [ones] * 3]

    total = None
    for k in range(4):
        off = offsets[k]
        p = _permute(_permute(_permute(i[2] + off[2]) + i[1] + off[1]) + i[0] + off[0])
        j = p - 49.0 * torch.floor(p * NS_Z * NS_Z)
        xq = torch.floor(j * NS_Z)
        yq = torch.floor(j - 7.0 * xq)
        x = xq * NS_X + NS_Y
        y = yq * NS_X + NS_Y
        h = 1.0 - torch.abs(x) - torch.abs(y)
        sh = -(h <= 0.0).to(v.dtype)
        a = [x + (torch.floor(x) * 2.0 + 1.0) * sh,
             y + (torch.floor(y) * 2.0 + 1.0) * sh, h]
        norm = TAYLOR_A - TAYLOR_B * _dot3(a, a)
        a = [c * norm for c in a]
        m = torch.clamp_min(0.6 - _dot3(corners[k], corners[k]), 0.0)
        m = m * m
        term = m * m * _dot3(a, corners[k])
        total = term if total is None else total + term
    return 42.0 * total


def sdf_box(p: torch.Tensor, s) -> torch.Tensor:
    """Rounded box of half-size ``s`` (three numbers)."""
    q = [torch.abs(p[..., k]) - float(s[k]) for k in range(3)]
    out = [torch.clamp_min(c, 0.0) for c in q]
    outside = torch.sqrt(_dot3(out, out))
    inside = torch.clamp_max(torch.maximum(torch.maximum(q[0], q[1]), q[2]), 0.0)
    return outside + inside


def sdf_cone(p: torch.Tensor, c, h: float) -> torch.Tensor:
    """Capped cone (Inigo Quilez's sdCappedCone), ``c`` two numbers and
    ``h`` a number, as the island uses it."""
    c = np.asarray(c, np.float32)
    qx = float(np.float32(h) * (c[0] / c[1]))
    qy = float(np.float32(h) * np.float32(-1.0))
    w0 = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2])
    w1 = p[..., 1]
    qq = float(np.float32(qx) * np.float32(qx) + np.float32(qy) * np.float32(qy))
    ta = torch.clamp(div_scalar(w0 * qx + w1 * qy, qq), 0.0, 1.0)
    a0, a1 = w0 - qx * ta, w1 - qy * ta
    tb = torch.clamp(div_scalar(w0, qx), 0.0, 1.0)
    b0, b1 = w0 - qx * tb, w1 - qy * 1.0
    k = float(np.sign(np.float32(qy)))
    d = torch.minimum(a0 * a0 + a1 * a1, b0 * b0 + b1 * b1)
    s = torch.maximum(k * (w0 * qy - w1 * qx), k * (w1 - qy))
    return torch.sqrt(d) * torch.sign(s)


def smin(a: torch.Tensor, b: torch.Tensor, k: float) -> torch.Tensor:
    """Polynomial smooth min."""
    h = torch.clamp(0.5 + div_scalar(0.5 * (a - b), k), 0.0, 1.0)
    return a + (b - a) * h - k * h * (1.0 - h)


def smoothstep(e0: float, e1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(div_scalar(x - e0, e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _cos_sin(angle, like: torch.Tensor):
    a = torch.as_tensor(angle, dtype=like.dtype, device=like.device)
    return torch.cos(a), torch.sin(a)


def rotate_x(v: torch.Tensor, angle) -> torch.Tensor:
    """Rotate about +x."""
    c, s = _cos_sin(angle, v)
    return torch.stack([v[..., 0], v[..., 1] * c - v[..., 2] * s,
                        v[..., 1] * s + v[..., 2] * c], dim=-1)


def rotate_y(v: torch.Tensor, angle) -> torch.Tensor:
    """Rotate about +y."""
    c, s = _cos_sin(angle, v)
    return torch.stack([v[..., 0] * c + v[..., 2] * s, v[..., 1],
                        v[..., 2] * c - v[..., 0] * s], dim=-1)


def rotate_z(v: torch.Tensor, angle) -> torch.Tensor:
    """Rotate about +z."""
    c, s = _cos_sin(angle, v)
    return torch.stack([v[..., 0] * c - v[..., 1] * s,
                        v[..., 0] * s + v[..., 1] * c, v[..., 2]], dim=-1)


def rotate(v: torch.Tensor, axis, angle) -> torch.Tensor:
    """Rodrigues rotation about an arbitrary ``axis`` (three numbers)."""
    axis = torch.as_tensor(axis, dtype=v.dtype, device=v.device)
    axis = axis / torch.sqrt(_dot3(axis, axis))
    c, s = _cos_sin(angle, v)
    ax = axis.expand_as(v)
    return (v * c + torch.linalg.cross(ax, v) * s
            + axis * _dot3(axis, v.unbind(-1))[..., None] * (1 - c))


def hash_rand(co: torch.Tensor) -> torch.Tensor:
    """Fract-sin hash of the first two components."""
    x = torch.sin(co[..., 0] * 12.9898 + co[..., 1] * 78.233) * 43758.5453
    return x - torch.floor(x)
