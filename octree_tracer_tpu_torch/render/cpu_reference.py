"""NumPy oracle: the JAX package's ``render/cpu_reference.py`` (``trace_rays``,
``shade`` and ``render_frame``), copied so that the port checks its kernels
against the oracle, and ``app.headless`` renders with it, without importing
any module of that package (tests hold the copy equal to the original).
Float32 slab entry into the [-1, 1]^3 root cube, re-descent from the root
after every boundary step (2e-6 face nudge), the 100-step cap and the
strict ``>`` descent by default.
"""

from __future__ import annotations

import numpy as np

from ..core.voxel import VOXEL_OFFSET

F = np.float32
_EPS_DIR = F(1e-6)
_EPS_NUDGE = F(2e-6)
MAX_STEPS = 100
DEFAULT_SUN = (-1.7, -1.0, 0.8)


def _in_bounds(v: np.ndarray) -> np.ndarray:
    """step(-1, v) - step(1, v) product test (reference: src/shader.wgsl:177-180):
    true iff every component is in [-1, 1)."""
    return np.all((v >= F(-1.0)) & (v < F(1.0)), axis=-1)


def _ray_box_dist(pos: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Slab test against the root cube; 0 encodes a miss
    (reference: src/shader.wgsl:66-80)."""
    t1 = (F(-1.0) - pos) / dirs
    t2 = (F(1.0) - pos) / dirs
    tmin = np.minimum(t1, t2)
    tmax = np.maximum(t1, t2)
    v7 = tmin.max(axis=-1)
    v8 = tmax.min(axis=-1)
    return np.where((v8 < F(0.0)) | (v7 > v8), F(0.0), v7)


def trace_rays(
    words: np.ndarray,
    origin: np.ndarray,
    dirs: np.ndarray,
    max_steps: int = MAX_STEPS,
    visits: np.ndarray | None = None,
    strict_descent: bool = True,
):
    """Trace rays through node pool ``words``.

    ``origin`` may be a single f32[3] (primary rays) or f32[N,3] (per-ray
    origins, e.g. shadow rays). Returns a dict of per-ray arrays: ``hit`` bool,
    ``forced`` bool (step-cap hits), ``index`` int32 node slot,
    ``hit_pos``/``normal`` f32[N,3], ``steps``/``depth`` int32.

    When ``visits`` (int32[pool]) is given, every visited node slot gets +1 per
    visit — the race-free equivalent of the shader's saturating in-traversal
    counter RMW (src/shader.wgsl:157-161; equivalence holds because the host
    re-upload zeroes counters every frame, src/app.rs:113-118).
    """
    words = np.ascontiguousarray(words, dtype=np.uint32)
    dirs = np.asarray(dirs, dtype=F).reshape(-1, 3)
    n = dirs.shape[0]
    origin = np.asarray(origin, dtype=F)
    pos = np.broadcast_to(origin.reshape(-1, 3), (n, 3)).astype(F).copy()

    d = dirs.copy()
    d[d == F(0.0)] = _EPS_DIR

    inside = _in_bounds(pos)
    dist = _ray_box_dist(pos, d)
    entered = inside | (dist != F(0.0))
    pos = np.where(inside[:, None], pos, pos + d * dist[:, None]).astype(F)

    r_sign = np.sign(d).astype(F)

    active = entered.copy()
    hit = np.zeros(n, dtype=bool)
    forced = np.zeros(n, dtype=bool)
    index = np.full(n, -1, dtype=np.int32)
    out_pos = np.zeros((n, 3), dtype=F)
    out_normal = np.zeros((n, 3), dtype=F)
    out_steps = np.zeros(n, dtype=np.int32)
    out_depth = np.zeros(n, dtype=np.int32)

    voxel_pos = pos.copy()
    normal = np.trunc(pos * F(1.000001)).astype(F)
    steps = np.zeros(n, dtype=np.int32)
    node_index = np.zeros(n, dtype=np.int64)
    node_pos = np.zeros((n, 3), dtype=F)
    depth = np.zeros(n, dtype=np.int32)

    voxel_offset = np.uint32(VOXEL_OFFSET)
    # Safety cap: a valid pool is at most ~24 deep; every step costs <= depth+1
    # iterations.
    for _ in range((max_steps + 2) * 26):
        if not active.any():
            break
        a = active
        ai = np.nonzero(a)[0]

        depth[a] += 1
        if strict_descent:
            p = (voxel_pos[a] > node_pos[a]).astype(F)
        else:
            p = (voxel_pos[a] >= node_pos[a]).astype(F)
        child = (p[:, 0] * 4 + p[:, 1] * 2 + p[:, 2]).astype(np.int64)
        half = (F(1.0) / np.exp2(depth[a].astype(F)))[:, None]
        node_pos[a] = node_pos[a] + (p * F(2.0) - F(1.0)) * half
        idx = node_index[a] + child

        if visits is not None:
            np.add.at(visits, idx, 1)

        payload = words[idx] >> np.uint32(4)
        leaf = payload >= voxel_offset
        filled = payload > voxel_offset

        # Case 1: filled leaf -> hit.
        hit_rows = ai[leaf & filled]
        if hit_rows.size:
            hit[hit_rows] = True
            index[hit_rows] = idx[leaf & filled]
            out_pos[hit_rows] = voxel_pos[hit_rows]
            out_normal[hit_rows] = normal[hit_rows]
            out_steps[hit_rows] = steps[hit_rows]
            out_depth[hit_rows] = depth[hit_rows]
            active[hit_rows] = False

        # Case 2: interior -> descend.
        interior = ~leaf
        node_index[ai[interior]] = payload[interior].astype(np.int64)

        # Case 3: empty leaf -> boundary step + root restart.
        stepping = ai[leaf & ~filled]
        if stepping.size:
            dep = depth[stepping].astype(F)
            voxel_size = F(2.0) / np.exp2(dep)
            t_max = (
                node_pos[stepping]
                - pos[stepping]
                + r_sign[stepping] * (voxel_size[:, None] * F(0.5))
            ) / d[stepping]
            roll1 = t_max[:, [1, 2, 0]]
            roll2 = t_max[:, [2, 0, 1]]
            face = (t_max <= np.minimum(roll1, roll2)).astype(F)
            new_normal = face * -r_sign[stepping]
            t_current = t_max.min(axis=-1)
            new_vp = (
                pos[stepping]
                + d[stepping] * t_current[:, None]
                - new_normal * _EPS_NUDGE
            ).astype(F)

            oob = ~_in_bounds(new_vp)
            oob_rows = stepping[oob]
            if oob_rows.size:
                out_steps[oob_rows] = steps[oob_rows]
                out_depth[oob_rows] = depth[oob_rows]
                active[oob_rows] = False

            cont = stepping[~oob]
            steps_new = steps[cont] + 1
            over = steps_new > max_steps
            over_rows = cont[over]
            if over_rows.size:
                hit[over_rows] = True
                forced[over_rows] = True
                out_pos[over_rows] = new_vp[~oob][over]
                out_normal[over_rows] = new_normal[~oob][over]
                out_steps[over_rows] = steps_new[over]
                out_depth[over_rows] = max_steps
                active[over_rows] = False

            go = cont[~over]
            if go.size:
                keep2 = np.zeros(n, dtype=bool)
                keep2[go] = True
                sel = keep2[stepping]
                voxel_pos[go] = new_vp[sel]
                normal[go] = new_normal[sel]
                steps[go] = steps_new[~over]
                node_index[go] = 0
                node_pos[go] = F(0.0)
                depth[go] = 0

    return {
        "hit": hit,
        "forced": forced,
        "index": index,
        "hit_pos": out_pos,
        "normal": out_normal,
        "steps": out_steps,
        "depth": out_depth,
    }


def shade(
    words: np.ndarray,
    result: dict,
    sun_dir=DEFAULT_SUN,
    shadows: bool = True,
    show_steps: bool = False,
    visits: np.ndarray | None = None,
    max_steps: int = MAX_STEPS,
    gamma: float = 2.2,
):
    """Shade traced rays (reference: src/shader.wgsl:251-305): ambient 0.3 +
    lambertian vs the sun, optional 1-bounce shadow ray, miss -> 0.2 grey,
    forced step-cap hits -> red, gamma out (2.2, or 1.0 under misc_bool).
    Returns f32[N,3] colours."""
    n = result["hit"].shape[0]

    if show_steps:
        g = result["steps"].astype(F) / F(64.0)
        colour = np.stack([g, g, g], axis=-1)
        return np.clip(colour, F(0.0), F(1.0)) ** F(gamma)

    colour = np.full((n, 3), F(0.2))
    hit = result["hit"]
    sun = np.asarray(sun_dir, dtype=F)
    sun = sun / F(np.linalg.norm(sun))

    diffuse = np.maximum((result["normal"] * -sun).sum(axis=-1), F(0.0)).astype(F)

    if shadows and hit.any():
        # Shadow ray: origin offset 2.5e-6 along the normal, direction -sun;
        # shadow rays are "primary" in the reference and bump counters too
        # (reference: src/shader.wgsl:275-280).
        hp = (result["hit_pos"][hit] + result["normal"][hit] * F(2.5e-6)).astype(F)
        sh = trace_rays(
            words,
            hp,
            np.broadcast_to(-sun, (int(hit.sum()), 3)),
            max_steps=max_steps,
            visits=visits,
        )
        diffuse_hit = diffuse[hit]
        diffuse_hit[sh["hit"]] = F(0.0)
        diffuse[hit] = diffuse_hit

    payload = (words[np.maximum(result["index"], 0)] >> np.uint32(4)).astype(np.uint32)
    rgb24 = payload - np.uint32(VOXEL_OFFSET)
    base = (
        np.stack([(rgb24 >> 16) & 0xFF, (rgb24 >> 8) & 0xFF, rgb24 & 0xFF], axis=-1)
        .astype(F)
        / F(255.0)
    )
    lit = (F(0.3) + diffuse)[:, None] * base
    colour = np.where(hit[:, None], lit, colour)
    # Step-cap overflow renders red (reference: src/shader.wgsl:242-244).
    colour = np.where(
        result["forced"][:, None], np.array([1.0, 0.0, 0.0], dtype=F), colour
    )
    return np.clip(colour, F(0.0), F(1.0)) ** F(gamma)


def render_frame(
    words: np.ndarray,
    origin,
    dirs,
    sun_dir=DEFAULT_SUN,
    shadows: bool = True,
    show_steps: bool = False,
    with_visits: bool = False,
    strict_descent: bool = True,
    gamma: float = 2.2,
):
    """Full oracle frame: primary trace + shadow + shade.

    ``dirs`` shaped (H, W, 3); returns (image f32[H,W,3], result dict, visits).
    """
    dirs = np.asarray(dirs, dtype=F)
    h, w = dirs.shape[:2]
    visits = np.zeros(words.shape[0], dtype=np.int64) if with_visits else None
    result = trace_rays(
        words, origin, dirs.reshape(-1, 3), visits=visits,
        strict_descent=strict_descent,
    )
    img = shade(
        words, result, sun_dir=sun_dir, shadows=shadows, show_steps=show_steps,
        visits=visits, gamma=gamma,
    )
    return img.reshape(h, w, 3), result, visits
