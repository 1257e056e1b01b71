"""The plain reference frame: the octree renderer's traversal, shading and
display encode in plain PyTorch, one operation a line, on whatever device
its tensors are on.

It follows the upstream shader (ria8651/octree-tracer ``src/shader.wgsl``)
as the NumPy oracle of the repository writes it: slab entry into the
[-1, 1]^3 root cube, the strict ``>`` descent from the root, a boundary step
out of every empty leaf (the exit face nudged by 2e-6) and a fresh descent
from the root after it, the 100-step cap (a forced hit, shaded red), ambient
0.3 plus Lambert against the sun, a shadow ray from 2.5e-6 off the hit along
its normal, the 0.2 grey sky, gamma 2.2, and the display encode
``clip^(1/2.2) * 255`` truncated to a byte. Visits count every read of a
slot by a primary or a shadow ray.

``dtype`` sets the precision of the ray arithmetic: float32 is the
reference; a lower one (bfloat16) is the control that the comparison must
fail. Pools are u32 words as int64 tensors (``widen``), so nothing here
reads a table, a bucket or a packed layout of the program.
"""

from __future__ import annotations

import numpy as np
import torch

VOXEL_OFFSET = 1 << 27
MAX_STEPS = 100
SUN = (-1.7, -1.0, 0.8)
EPS_DIR = 1e-6
EPS_NUDGE = 2e-6
SHADOW_OFFSET = 2.5e-6


def widen(words: torch.Tensor) -> torch.Tensor:
    """u32 words (any integer dtype holding their bits) as int64 values."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _in_bounds(v: torch.Tensor) -> torch.Tensor:
    return ((v >= -1.0) & (v < 1.0)).all(dim=-1)


def trace_rays(words: torch.Tensor, origin: torch.Tensor, dirs: torch.Tensor,
               visits: torch.Tensor | None = None, max_steps: int = MAX_STEPS,
               dtype=torch.float32) -> dict:
    """Trace rays f32[N, 3] from ``origin`` (f32[3] or f32[N, 3]) through the
    pool ``words`` (int64 u32 values). Returns per-ray ``hit``, ``forced``,
    ``index`` (the hit leaf's slot, -1 otherwise), ``hit_pos``, ``normal``,
    ``steps``. ``visits`` (int64[pool]) gains one per slot read."""
    dev = dirs.device
    n = dirs.shape[0]
    one = torch.ones((), dtype=dtype, device=dev)
    d = dirs.to(dtype).clone()
    d = torch.where(d == 0, torch.full_like(d, EPS_DIR), d)
    pos = origin.to(dtype).expand(n, 3).clone()

    inside = _in_bounds(pos)
    t1 = (-one - pos) / d
    t2 = (one - pos) / d
    v7 = torch.minimum(t1, t2).amax(dim=-1)
    v8 = torch.maximum(t1, t2).amin(dim=-1)
    dist = torch.where((v8 < 0) | (v7 > v8), torch.zeros_like(v7), v7)
    entered = inside | (dist != 0)
    pos = torch.where(inside[:, None], pos, pos + d * dist[:, None])
    sign = torch.sign(d)

    out = {"hit": torch.zeros(n, dtype=torch.bool, device=dev),
           "forced": torch.zeros(n, dtype=torch.bool, device=dev),
           "index": torch.full((n,), -1, dtype=torch.int64, device=dev),
           "hit_pos": torch.zeros(n, 3, dtype=dtype, device=dev),
           "normal": torch.zeros(n, 3, dtype=dtype, device=dev),
           "steps": torch.zeros(n, dtype=torch.int64, device=dev)}

    # The state of the rays still active, compacted each iteration.
    rid = torch.nonzero(entered).squeeze(1)
    p0, dd, sg = pos[rid], d[rid], sign[rid]
    vpos = p0.clone()
    normal = torch.trunc(p0 * 1.000001)
    steps = torch.zeros(rid.shape[0], dtype=torch.int64, device=dev)
    node = torch.zeros(rid.shape[0], dtype=torch.int64, device=dev)
    npos = torch.zeros(rid.shape[0], 3, dtype=dtype, device=dev)
    depth = torch.zeros(rid.shape[0], dtype=torch.int64, device=dev)
    weights = torch.tensor([4, 2, 1], dtype=torch.int64, device=dev)

    for _ in range((max_steps + 2) * 26):
        if rid.numel() == 0:
            break
        depth = depth + 1
        p = vpos > npos
        child = (p.to(torch.int64) * weights).sum(dim=1)
        half = torch.ldexp(one.expand(depth.shape[0]), -depth)
        npos = npos + (p.to(dtype) * 2.0 - 1.0) * half[:, None]
        idx = node + child
        if visits is not None:
            visits.index_add_(0, idx, torch.ones_like(idx))
        payload = words[idx] >> 4
        leaf = payload >= VOXEL_OFFSET
        filled = payload > VOXEL_OFFSET

        # A filled leaf ends the ray with a hit.
        h = leaf & filled
        r = rid[h]
        out["hit"][r] = True
        out["index"][r] = idx[h]
        out["hit_pos"][r] = vpos[h]
        out["normal"][r] = normal[h]
        out["steps"][r] = steps[h]

        # An interior descends; an empty leaf steps out of its cell.
        node = torch.where(leaf, node, payload)
        e = leaf & ~filled
        size = torch.ldexp(one.expand(depth.shape[0]), 1 - depth)
        t_max = (npos - p0 + sg * (size[:, None] * 0.5)) / dd
        face = (t_max <= torch.minimum(t_max[:, [1, 2, 0]], t_max[:, [2, 0, 1]])).to(dtype)
        new_normal = face * -sg
        t_cur = t_max.amin(dim=1)
        new_vp = p0 + dd * t_cur[:, None] - new_normal * EPS_NUDGE
        oob = e & ~_in_bounds(new_vp)
        out["steps"][rid[oob]] = steps[oob]
        go = e & ~oob
        steps = torch.where(go, steps + 1, steps)
        over = go & (steps > max_steps)
        r = rid[over]
        out["hit"][r] = True
        out["forced"][r] = True
        out["hit_pos"][r] = new_vp[over]
        out["normal"][r] = new_normal[over]
        out["steps"][r] = steps[over]
        restart = go & ~over
        vpos = torch.where(restart[:, None], new_vp, vpos)
        normal = torch.where(restart[:, None], new_normal, normal)
        node = torch.where(restart, 0, node)
        npos = torch.where(restart[:, None], torch.zeros_like(npos), npos)
        depth = torch.where(restart, 0, depth)

        keep = ~(h | oob | over)
        rid, p0, dd, sg = rid[keep], p0[keep], dd[keep], sg[keep]
        vpos, normal, steps = vpos[keep], normal[keep], steps[keep]
        node, npos, depth = node[keep], npos[keep], depth[keep]
    return out


def shade(words: torch.Tensor, result: dict, sun_dir=SUN, shadows: bool = True,
          visits: torch.Tensor | None = None, dtype=torch.float32,
          gamma: float = 2.2) -> tuple[torch.Tensor, torch.Tensor]:
    """(colours f32[N, 3], shadow hit bool[N]) of traced rays: the sky 0.2
    grey, a hit its leaf's colour times 0.3 plus the Lambert term unless its
    shadow ray hits, a forced hit red, then ``^gamma``."""
    hit = result["hit"]
    dev = hit.device
    s = np.asarray(sun_dir, dtype=np.float32)
    s = s / np.sqrt(np.sum(s * s, dtype=np.float32))
    sun = torch.from_numpy(s).to(dev, dtype)
    nrm = result["normal"]
    diffuse = torch.clamp_min(((nrm * -sun)[:, 0] + (nrm * -sun)[:, 1]) + (nrm * -sun)[:, 2], 0)
    shadow = torch.zeros_like(hit)
    if shadows and bool(hit.any()):
        hi = torch.nonzero(hit).squeeze(1)
        origins = result["hit_pos"][hi] + nrm[hi] * SHADOW_OFFSET
        sh = trace_rays(words, origins, (-sun).expand(hi.shape[0], 3), visits=visits,
                        dtype=dtype)
        shadow[hi] = sh["hit"]
    diffuse = torch.where(shadow, torch.zeros_like(diffuse), diffuse).to(torch.float32)
    rgb = (words[result["index"].clamp_min(0)] >> 4) - VOXEL_OFFSET
    base = torch.stack([(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF, rgb & 0xFF],
                       dim=-1).to(torch.float32) / torch.tensor(255.0, device=dev)
    lit = (0.3 + diffuse)[:, None] * base
    colour = torch.where(hit[:, None], lit, torch.tensor(0.2, device=dev))
    red = torch.tensor([1.0, 0.0, 0.0], device=dev)
    colour = torch.where(result["forced"][:, None], red, colour)
    return colour.clamp(0.0, 1.0) ** gamma, shadow


def encode_u8(colour: torch.Tensor) -> torch.Tensor:
    """The display encode: ``clip^(1/2.2) * 255`` truncated to u8."""
    return (colour.clamp(0.0, 1.0) ** (1.0 / 2.2) * 255.0).to(torch.uint8)


def render(words: torch.Tensor, origin: torch.Tensor, dirs: torch.Tensor, sun_dir=SUN,
           shadows: bool = True, with_visits: bool = False, dtype=torch.float32) -> dict:
    """A whole frame of rays f32[N, 3]: the primary result, the shadow hits,
    the u8 pixels [N, 3] and, ``with_visits``, the visits int64[pool] of both
    passes."""
    visits = (torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
              if with_visits else None)
    result = trace_rays(words, origin, dirs, visits=visits, dtype=dtype)
    colour, shadow = shade(words, result, sun_dir, shadows, visits, dtype)
    result.update(shadow=shadow, u8=encode_u8(colour), visits=visits)
    return result
