#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's twelve CUDA kernels from ``octree_tracer_tpu_torch/csrc``
(one ``nvcc`` per source, all started together), checks each against its
plain PyTorch version at the main paths' shapes, checks the traversal kernel
against the NumPy oracle on a subsample, and drives the main paths:

- the tables (4): K2 equal to its plain version at every level 0-9 on the
  deep10 pool and on pools whose pointers run past their end or cycle
  (``scenes.malformed_pools``), and K1 and K4's hit-counter view equal to
  theirs on those pools, from a camera on a centre plane too, where the
  cyclic pool's descents pass 126 levels; K12 (``skip.build_skip_field``)
  equal to the NumPy build bit for bit at every level 0-8 on deep10, on the
  malformed pools and on random occupancies, its in-place skip half equal
  to a fresh table's;
- the frame: the bench's deep10 scene at 1920x1080 with shadows and the
  combined level-7 warp+skip table (phases 3-8): K1's tiled call from one
  stride-0 origin against the flat contiguous call and the plain version,
  K1's shadow mode against ``shadow_rays`` + ``trace_plain``, and a
  ``torch.profiler`` breakdown of the frame;
- the adaptive streaming Session on the deep10 shell world at 1920x1080,
  with visit counting, candidate selection and the visit closure on the
  card (phases 9-11), each step's table, frame and stats equal to a twin
  Session's whose skip halves take the plain path, and a CPU Session (plain
  versions) against a CUDA Session (kernels) in lockstep (phase 12);
- K1's root-restart form (9b, ``parent_restart=False``, the reference's full
  re-descent) on the deep10 1080p primaries without a table and with the
  combined table: counts, flags and shadow counts equal to its plain
  version, every field equal to the parent form's, both forms timed alone
  in turn, each pass's byte bound (the counting pass's with the marked
  slots), its latency bound (the longest ray's trips times K1's trip on
  L2-resident rows, ``trip_latency_ns``) and the visit atomics a counted
  pass issues (an instrumented copy of the kernel,
  ``probes/k1_counters.py``), and the counted frame in that form through
  ``render_frame`` (its launches in the kernels line as
  ``root_restart.frame_launches``);
  phase 4 also runs the malformed pools in both forms, and phase 2 checks
  that every K1 instantiation of both forms keeps 48 registers or fewer
  (the brick forms and the combined table's counting forms 64) and that no
  kernel spills;
- brick maps and paged pools (9c) on deep10 at 1080p: K10
  (``bricks.build_bricks``) equal to its plain version and to
  ``build_bricks_np`` on deep10's pool and the malformed pools, timed;
  K1's brick mode (no table) equal to its plain version on every field,
  the shadow mask and every visit slot in both restart forms, and to the
  no-table form without bricks on every field, also on random trees, a
  dense slab at max_steps 6 and the malformed pools; the primary pass,
  the shadow mode and the shadowed u8 frame with bricks timed in turn
  against the no-table form and the combined table, the warps' split
  between brick trips and descents (``k1_counters``) and the latency
  bounds; the same on the generated island terrain (``scenes.terrain(9)``,
  the scene bricks are for) from its grazing camera at 1920x1080, the
  brick forms equal to plain on the image rows ``TERRAIN_ROWS`` and to the
  no-table form over the whole frame; the slice's path
  (``build_bricks``, raygen, ``render_frame(bricks=...)``) counted; and
  ``build_pages`` of deep10 with the paged frame equal to the unpaged
  one after the remap, K1 over the relayout timed against the original;
- the JAX frame's schedules and ray orders (9d) on deep10 at 1080p: K3's
  block-order form and K11 (``beam_start``) equal to their plain versions,
  K11 on the terrain too, K1's start forms equal to plain on every field
  and visit slot and to the pass without starts on every hit field, the
  start forms of both restart forms and all three table kinds and of
  brick mode and the seed forms (a table for first descents only,
  primary and shadow mode) equal to plain on a band of rows, JAX's
  flagship call (beam mode, rays in the block order, ``pre_permuted``,
  ``raw_result``, u8, the combined table) equal to the pixel-order frame,
  K4's block-order writes equal, the staged frame with ``beams`` equal to
  the one without, the staged frame with ``warp_in_body=False`` and
  ``trace_staged`` with a table equal to plain on the band; these paths
  counted (K3's block form, K11, the start and seed forms in the kernels
  line), the frames timed in turn;
- ray generation (5): K3 bit for bit with its plain version, its kernel-alone
  time beside the wrapper's, and one call from a NumPy matrix under
  ``torch.cuda.set_sync_debug_mode("error")`` (the matrix goes by value);
- procedural generation: the island SDF kernel on the production 512^3
  chunk and a second corner, every cell equal to the plain version (13),
  ``generate_world`` of the CLI's default world (14), and a
  Session flying that generated world, streaming its chunks in and out,
  with a CPU-vs-CUDA lockstep on a small generated world (15);
- the probes' row gathers and scalar adds at every shape of
  ``probes/gather_probe.py`` and ``probes/pallas_min_probe.py``, the
  one-block lines t1-t10b timed again 21 times each, kernel and library
  call in turn, and both kernels' edge paths against their plain versions:
  K8 on a width-3 table and a misaligned view, K9 on an odd length and a
  view one element off 16 bytes (16);
- the app, as a user runs it (17-21): deep10 through ``.rsvo`` and a
  generated 256^3 chunk through ``.vox`` and back (17); the CLI's
  ``render`` and ``bench`` of deep10.rsvo at 1920x1080 in their own
  processes, the PNG equal to a direct ``render_frame`` on every pixel
  (18); a synthetic asset root (8 blocks, 2 structures) and ``genworld
  --structures`` at the CLI's defaults, then CPU and CUDA chunk_depth 5
  worlds with structures byte-equal (19); ``fly`` over that world with the
  block library, 30 frames at 1920x1080 (20); and the HTTP viewer over a
  1920x1080 Session on it: the page, frames, 8 steps with movement and
  toggles, an Open of deep10.rsvo and a Regenerate at chunk_depth 5 (21).
  Each path's launches, counted in its own process (``--launch-counts``),
  go into the kernels line as ``app_launches``;
- the sharded path (22), ``octree_tracer_tpu_torch.parallel`` over
  ``torch.distributed``: an in-process NCCL group of world size 1 renders
  phase 8's frame through ``render_frame_sharded``, equal to
  ``render_frame`` on every pixel, result field and visit (counts and
  flags), and runs a ``ShardedSession`` of 24 steps equal to phase 11's
  Session at every step (u8 frames, pools and tables by digest, stats,
  node_stats, selection offsets); two gloo ranks spawned on the one card
  (540 rows each) run 24 steps, both equal to phase 11's, and
  four (270 rows each) render phase 8's frame equal to ``render_frame``;
  then ``dryrun_multichip(2)``. Each part of the sharded frame (the rank's
  rows, the visit all-reduce, the frame all-gather, a step message's
  broadcast) is timed on every rank; each path's launches, counted on each
  rank, go into the kernels line as ``sharded_launches``.

    python3 chip_smoke.py        # from the repository root, one GPU

Every phase prints a line; any failure raises and exits non-zero. Without a
CUDA device it exits 1 and prints no result. The line before the last is a
JSON object with each kernel's launches on the Session path (and on the
frame path), its largest difference from the plain version and both times:
``ms`` is the wrapper's calls back to back, host included (K1-K7), or the
probe line's device time behind a spin (K8, K9, whose host enqueue outlasts
the kernel); K2, K3, K4 and K5 add ``alone_ms``, the kernel alone behind a
spin as ``probes/kernel_steps.py`` times it; the last line is
``{"ok": true, "device": {...}}``. Each kernel's ``bound_ms`` is the least
time the card could take for its work in this run (bytes over 3.35 TB/s,
or f32 operations over 67 TFLOP/s, the larger; K2's counts each 32-byte
pool sector its descents read once, ``tracer.k2_bytes``, with the outputs
alone beside it; K1's
counts each 32-byte pool row that this run's rays touch once, as their visit
counts show, K6's every pass, K7's the operations its grid needs with the
noise's permutations and gradients from one table and the terms of x and z
once a column, ``procedural.k7_ops``, and K8's each distinct table row its
starts reach once), and ``library_ms`` the time of the one
PyTorch call that computes the same function, where there is one.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

W, H = 1920, 1080
DEPTH = 10
LEVELS = 7
# The bench's deep10 camera (bench.py:255-257).
CAM_POS = np.array([0.2, 0.3, -2.4], np.float32)
CAM_LOOK = np.array([-0.1, -0.15, 1.0], np.float32)
FOV = 70.0
ORACLE_RAYS = 16384
WARMUP, TIMED = 2, 5
PROFILED = 5
# Phase 16: every one-block probe line of K9 (t1-t4) and K8 (t5-t10b),
# timed again in turn with its library call.
RETIMED = ("t1", "t2", "t3", "t4", "t5", "t6", "t7", "t8", "t9", "t10", "t10b")
RETIME_SAMPLES = 21
SESSION_STEPS = 24
# Phase 12: a generic camera (from the default Character view knife-edge
# rays can flip between implementations), and a turn for collapses.
LOCK_RES, LOCK_DEPTH, LOCK_STEPS, LOCK_TURN = (128, 72), 8, 12, 8
LOCK_POS = np.array([0.25, 0.35, -2.3], np.float32)
LOCK_LOOK = np.array([-0.12, -0.17, 1.0], np.float32)
FRAME_KERNELS = ("trace", "warp_occupancy", "skip_field", "raygen", "shade_encode")
SESSION_KERNELS = FRAME_KERNELS + ("select_candidates", "propagate_visits")
# Procedural generation: the production chunk (bench.py:333-337) and the
# CLI's default world (app/cli.py:240-241), then a Session over it.
# Phase 9c's terrain (scenes.terrain, K7's 512^3 grid) and the image rows
# held to the plain version (around the horizon, where rays graze).
TERRAIN_DEPTH, TERRAIN_ROWS = 9, (432, 560)
GEN_DEPTH, WORLD_DEPTH = 9, 1
GEN_CORNER = (-1.0, -1.0, -1.0)
GEN_CORNERS = (GEN_CORNER, (0.0, -1.0, 0.0))
GEN_STEPS, GEN_TURN = 30, 22
GEN_LOCK_DEPTH, GEN_LOCK_STEPS, GEN_LOCK_TURN = 5, 12, 8
# Phases 17-21: a generated chunk through .vox at its largest side (256),
# the CLI's fly, and the viewer's steps.
APP_VOX_DEPTH, APP_GEN_ID = 8, 1 << 30
FLY_FRAMES, VIEW_STEPS = 30, 8
# Phase 22: calls of each part of the sharded frame timed.
SHARD_TIMED = 10
REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12

KERNELS = {
    "trace": ("octree_tracer_tpu_torch/csrc/trace.cu",
              "octree_tracer_tpu/render/tracer.py:135"),
    "warp_occupancy": ("octree_tracer_tpu_torch/csrc/warp_occupancy.cu",
                       "octree_tracer_tpu/render/tracer.py:2859"),
    "skip_field": ("octree_tracer_tpu_torch/csrc/skip_field.cu",
                   "octree_tracer_tpu/render/skip.py:141"),
    "raygen": ("octree_tracer_tpu_torch/csrc/raygen.cu",
               "octree_tracer_tpu/render/camera.py:100"),
    "shade_encode": ("octree_tracer_tpu_torch/csrc/shade_encode.cu",
                     "octree_tracer_tpu/render/tracer.py:3132"),
    "select_candidates": ("octree_tracer_tpu_torch/csrc/select_candidates.cu",
                          "octree_tracer_tpu/adaptive/feedback.py:33"),
    "propagate_visits": ("octree_tracer_tpu_torch/csrc/propagate_visits.cu",
                         "octree_tracer_tpu/adaptive/feedback.py:96"),
    "block_grid": ("octree_tracer_tpu_torch/csrc/block_grid.cu",
                   "octree_tracer_tpu/gen/procedural.py:84"),
    "gather_rows": ("octree_tracer_tpu_torch/csrc/gather_rows.cu",
                    "probes/gather_probe.py:264"),
    "add_scalar": ("octree_tracer_tpu_torch/csrc/add_scalar.cu",
                   "probes/pallas_min_probe.py:44"),
    "brick_rows": ("octree_tracer_tpu_torch/csrc/brick_rows.cu",
                   "octree_tracer_tpu/render/bricks.py:110"),
    "beam_start": ("octree_tracer_tpu_torch/csrc/beam_start.cu",
                   "octree_tracer_tpu/render/tracer.py:2987"),
    # K3's block-order form (its own kernel in raygen.cu), phase 9d.
    "raygen_block_major": ("octree_tracer_tpu_torch/csrc/raygen.cu",
                           "octree_tracer_tpu/render/camera.py:100"),
}


# What phases 9b and 9c share: K1's registers by form (phase 2), the
# instrumented counters' build and library (probes/k1_counters.py), and K1's
# trip time on L2-resident rows (``trip_latency_ns``).
K1: dict = {"registers": {}}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` on the device, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float = 0.0) -> dict:
    """bound_ms and bound_by for work that moves ``nbytes`` and does ``ops``
    f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def max_abs_err(pairs) -> float:
    """The largest |a - b| over the pairs of tensors compared (an integer
    tensor's bits as their int32 values)."""
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def kernel_name(mangled: str) -> str:
    """A kernel's name from ptxas's mangled one (the last component of a
    nested name); K1's with its template arguments (strict descent, table
    mode, visit mode, shadow mode, root restart, brick mode)."""
    m = re.search(r"trace_kernelILb(\d)ELi(\d)ELi(\d)ELb(\d)ELb(\d)ELb(\d)E", mangled)
    if m:
        return ("trace_kernel<strict={}, table={}, visits={}, shadow={}, root={}, bricks={}>"
                .format(*m.groups()))
    m = re.search(r"trace_start_kernelILb(\d)ELi(\d)ELi(\d)ELb(\d)ELb(\d)E", mangled)
    if m:
        return ("trace_start_kernel<strict={}, table={}, visits={}, root={}, bricks={}>"
                .format(*m.groups()))
    m = re.search(r"trace_seed_kernelILb(\d)ELi(\d)ELb(\d)ELb(\d)E", mangled)
    if m:
        return "trace_seed_kernel<strict={}, visits={}, shadow={}, root={}>".format(*m.groups())
    pos, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + m.end()
        name, pos = mangled[start:start + int(m.group())], start + int(m.group())
    return name


def profile_frames(fn, reps: int):
    """Device time by kernel over ``reps`` calls of ``fn`` from
    torch.profiler: ([(kernel, ms a call)], busy share of the window from the
    first kernel's start to the last one's end)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    by_kernel = sorted(((e.key, getattr(e, "self_device_time_total",
                                        getattr(e, "self_cuda_time_total", 0.0)) / reps / 1e3)
                        for e in prof.key_averages()), key=lambda kv: -kv[1])
    return [kv for kv in by_kernel if kv[1] > 0], (busy / window if window else 0.0)


def digest(t) -> str:
    """sha256 of a tensor's bytes ("none" for None)."""
    if t is None:
        return "none"
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def step_record(sess, host_img, stats, ms) -> dict:
    """What a Session step left: the u8 frame's, the pool's and the table's
    digests, the stats, node_stats, the selection offset and the step ms."""
    return {"img": digest(host_img), "pool": digest(sess.device_words),
            "table": digest(sess._warp_table), "stats": stats,
            "node_stats": sess.node_stats(), "sel_offset": sess._sel_offset, "ms": ms}


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def malformed_trace_check(dev, pools: dict) -> str:
    """K1 against its plain version on pools whose pointers run past their
    end, with no table and with the combined level-3 table, from the bench
    camera and from inside the root cube, in both restart forms: every
    primary output, counted and flagged visits (the root form's flags held
    to its plain counts' nonzero set), and the shadow mode's hits and
    counts, exact; K4's hit-counter view on the result within 1e-6. The
    "plane" camera sits on a centre plane, where a cyclic pool's descents
    pass 126 levels."""
    from octree_tracer_tpu_torch.render import camera, skip, tracer

    res_px = 96
    cams = {"bench": (np.array([0.4, 0.6, -2.2], np.float32),
                      np.array([-0.2, -0.35, 1.0], np.float32)),
            "inside": (np.array([-0.35, 0.55, -0.6], np.float32),
                       np.array([0.3, -0.5, 1.0], np.float32)),
            # On the x = 0 centre plane: on self_cycle every descent takes a
            # child with x above the centre forever, past 126 levels, where
            # the powers of two turn subnormal and then 0, to the loop's cap.
            "plane": (np.array([0.0, 0.3, -0.45], np.float32),
                      np.array([0.3, -0.5, 1.0], np.float32))}
    hits = past = 0
    capped = {True: 0, False: 0}
    for name, words in pools.items():
        n_words = words.shape[0]
        tables = (None, skip.build_warp_skip_table(words, 3))
        for cam, (pos, look) in cams.items():
            ci = camera.camera_matrices(pos, look, 70.0, res_px, res_px)[1]
            origin, dirs = camera.generate_rays_device(ci, res_px, res_px, dev)
            origins = origin.reshape(1, 3).expand(res_px * res_px, 3)
            flat = dirs.reshape(-1, 3)
            for table in tables:
                for restart in (True, False):
                    what = (f"{name}, {cam} camera, {'no' if table is None else 'combined'} "
                            f"table, {'parent' if restart else 'root'} restart")
                    kw = dict(warp_table=table, parent_restart=restart)
                    marks = {}
                    for flags in (False, True):
                        v_k = torch.zeros(n_words, dtype=torch.int32, device=dev)
                        r_k = tracer.trace(words, origins, dirs, visits=v_k, visit_flags=flags,
                                           **kw)
                        if restart or not flags:
                            v_p = torch.zeros_like(v_k)
                            r_p = tracer.trace_plain(words, origins, flat, visits=v_p,
                                                     visit_flags=flags, **kw)
                        else:
                            # The root form's plain flags: its plain counts'
                            # nonzero set (the same trips mark the same slots).
                            v_p = (marks[False] > 0).int()
                        check(all(torch.equal(a, b) for a, b in zip(r_k, r_p)),
                              f"trace differs from trace_plain on {what}")
                        check(torch.equal(v_k, v_p), f"trace visits (flags {flags}) differ "
                              f"from trace_plain's on {what}")
                        marks[flags] = v_k
                    counts = marks[False]
                    sh_k = torch.zeros(n_words, dtype=torch.int32, device=dev)
                    sh_p = torch.zeros_like(sh_k)
                    hit_k = tracer.trace_shadow(words, r_k, cull=False, visits=sh_k,
                                                image_width=res_px, **kw)
                    hit_p = tracer.trace_plain(words, *tracer.shadow_rays(r_k, cull=False),
                                               visits=sh_p, **kw).hit
                    check(torch.equal(hit_k, hit_p) and torch.equal(sh_k, sh_p),
                          f"trace_shadow differs from shadow_rays + trace_plain on {what}")
                    # K4's hit-counter view reads each hit's count at its slot,
                    # clamped into the pool.
                    err = float((tracer.shade(r_k, None, hits_visits=counts)
                                 - tracer.shade_plain(r_k, None, hits_visits=counts)
                                 ).abs().max())
                    check(err <= 1e-6, f"shade show_hits differs from plain by {err} on "
                          f"{what}")
                    if name == "self_cycle" and cam == "plane":
                        capped[restart] += int((~r_k.hit).sum())
                    if restart:
                        hits += int(r_k.hit.sum())
                        past += int((r_k.index >= n_words).sum())
    if "self_cycle" in pools:
        check(capped[True] > 0 and capped[False] > 0,
              f"no self_cycle ray descended to the loop's cap: {capped}")
    return (f"kernel equal to plain on {sorted(pools)} ({res_px}x{res_px} rays, bench, "
            f"inside and centre-plane cameras, no table and combined L3, parent and root "
            f"restart; primary outputs, counts, flags, shadow hits and counts; K4's "
            f"show_hits view within 1e-6): {hits} hits, {past} of them at slots past the "
            f"pool's end; {capped[True]} / {capped[False]} self_cycle rays (parent / root "
            f"restart) descended past 126 levels to the loop's cap")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        return run(torch.device("cuda", 0))
    finally:
        # The counters' nvcc (phase 2) if a phase failed before 9b, and its
        # directory.
        if "counters_build" in K1 and K1["counters_build"][0].poll() is None:
            K1["counters_build"][0].kill()
            K1["counters_build"][0].wait()
        if "counters_dir" in K1:
            shutil.rmtree(K1["counters_dir"], ignore_errors=True)


def plain_skip_field(words, levels=7, occ=None, table=None):
    """``skip.build_skip_field`` on the plain path on any device: K2's
    occupancy (when None), then the NumPy build, copied in."""
    from octree_tracer_tpu_torch.render import skip

    if occ is None:
        occ = skip.occupancy_from_pool(words, levels)
    field = skip.build_skip_field_plain(occ, levels)
    if table is None:
        return field
    table[1::2] = field
    return table


def plain_skip_session(*args, **kwargs):
    """A Session whose table builds and skip-half rebuilds take the plain
    path (``plain_skip_field``)."""
    import contextlib

    from octree_tracer_tpu_torch.app.session import Session
    from octree_tracer_tpu_torch.render import skip

    @contextlib.contextmanager
    def plain():
        kernel = skip.build_skip_field
        skip.build_skip_field = plain_skip_field
        try:
            yield
        finally:
            skip.build_skip_field = kernel

    class Plain(Session):
        def _build_table(self, combined):
            with plain():
                super()._build_table(combined)

        def _rebuild_skip_half(self):
            with plain():
                super()._rebuild_skip_half()

    return Plain(*args, **kwargs)


def skip_field_check(dev, report, words, malformed, occ, table, device_ms) -> None:
    """Phase 4's K12: equal to its plain version bit for bit on deep10 at
    levels 0-8, on the malformed pools at level 3 and on 5 random
    occupancies at level 7 (passed as ``occ``); its in-place write of a
    combined table's odd words equal to a fresh build, the warp words
    untouched; timed alone, back to back and plain at level 7 on deep10,
    the kernel in the form the Session launches, into a combined table's
    odd words, and alone in its stride-1 form beside it."""
    from octree_tracer_tpu_torch.render import skip, tracer

    plain7 = plain_skip_field(words, LEVELS, occ=occ)
    warp = tracer.warp_occupancy(words, LEVELS)[0]
    check(torch.equal(table[1::2], plain7) and torch.equal(table[0::2], warp),
          "the combined table differs from K2's warp words and the plain skip field")
    cases = 0
    for lv in range(9):
        check(torch.equal(skip.build_skip_field(words, lv), plain_skip_field(words, lv)),
              f"skip_field kernel differs from its plain version on deep{DEPTH} at L{lv}")
        cases += 1
    for name, pool in malformed.items():
        check(torch.equal(skip.build_skip_field(pool, 3), plain_skip_field(pool, 3)),
              f"skip_field kernel differs from its plain version on {name} at L3")
        cases += 1
    gen = torch.Generator(device=dev).manual_seed(12)
    for density in (0.001, 0.02, 0.2, 0.6, 0.95):
        rnd = torch.rand(8 ** LEVELS, device=dev, generator=gen) < density
        check(torch.equal(skip.build_skip_field(words, LEVELS, occ=rnd),
                          skip.build_skip_field_plain(rnd, LEVELS)),
              f"skip_field kernel differs from its plain version on density {density}")
        cases += 1
    stale = table.clone()
    stale[1::2] = 0
    skip.build_skip_field(words, LEVELS, table=stale)
    check(torch.equal(stale, table), "the in-place skip half differs from a fresh table")
    k12_bytes = skip.k12_bytes(LEVELS)
    report["skip_field"].update(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: skip.build_skip_field(words, LEVELS, occ=occ, table=stale), 20),
        alone_ms=device_ms(lambda: skip.build_skip_field(words, LEVELS, occ=occ, table=stale),
                           50),
        stride1_alone_ms=device_ms(lambda: skip.build_skip_field(words, LEVELS, occ=occ), 50),
        plain_ms=cuda_ms(lambda: skip.build_skip_field_plain(occ, LEVELS), 3),
        library_ms=None, **bound(k12_bytes), k12_bytes=k12_bytes,
    )
    r = report["skip_field"]
    phase("4 K12", f"equal to plain at every level 0-8 on deep{DEPTH}, on {sorted(malformed)} "
          f"at L3 and on 5 random occupancies at L{LEVELS} ({cases} cases); the in-place "
          f"skip half equal to a fresh table's; kernel into the table's odd words alone "
          f"{r['alone_ms']:.5f} ms (stride 1: {r['stride1_alone_ms']:.5f}), wrapper back to "
          f"back {r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms ({k12_bytes} bytes), plain "
          f"{r['plain_ms']:.3f} ms")


def run(dev: torch.device) -> int:
    from octree_tracer_tpu_torch import kernels, scenes, state
    from octree_tracer_tpu_torch.probes import k1_counters
    from octree_tracer_tpu_torch.probes.gather_probe import cuda_ms as device_ms
    from octree_tracer_tpu_torch.render import camera, cpu_reference, skip, tracer

    report = {k: {"name": k, "route": "cuda", "source": s, "replaces": r}
              for k, (s, r) in KERNELS.items()}

    # 1. The card and the toolchain.
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    phase("1 env", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc} device {torch.cuda.get_device_name(0)}")

    # 2. Build the kernel library from the sources.
    t0 = time.perf_counter()
    path, log = kernels.build()
    kernels.library()
    phase("2 build", f"{time.perf_counter() - t0:.1f} s -> {path}")
    k1_forms, start_forms, seed_forms = {}, {}, {}
    for fn, regs, spill_st, spill_ld in kernels.register_report(log):
        name = kernel_name(fn)
        phase("2 build", f"{name}: {regs} registers, spill stores "
              f"{spill_st} B, spill loads {spill_ld} B")
        check(spill_st == spill_ld == 0, f"{name}: spills {spill_st}/{spill_ld} B")
        if m := re.search(r"trace_seed_kernel<.*shadow=(\d), root=(\d)>", name):
            check(regs <= 48, f"{name}: {regs} registers")
            seed_forms[m.groups()] = seed_forms.get(m.groups(), 0) + 1
            K1["registers"][name] = regs
        elif m := re.search(r"root=(\d), bricks=(\d)>", name):
            # K1's launch bounds (5 blocks of 256 an SM) hold each form but
            # the brick forms and the combined table's counting forms (4
            # blocks, 64) to 48.
            four = m[2] == "1" or re.search(r"table=2, visits=[12]", name) is not None
            check(four or regs <= 48, f"{name}: {regs} registers")
            key = ("start",) + m.groups() if name.startswith("trace_start") else m.groups()
            forms = start_forms if name.startswith("trace_start") else k1_forms
            forms[key] = forms.get(key, 0) + 1
            K1["registers"][name] = regs
    want = {("0", "0"): 30, ("1", "0"): 30, ("0", "1"): 10, ("1", "1"): 10}
    check(k1_forms == want, f"K1 instantiations (root, bricks): {k1_forms}, expected {want}")
    # The start forms (phase 9d): primary only, every table and visit mode.
    want = {("start", "0", "0"): 18, ("start", "1", "0"): 18, ("start", "0", "1"): 6,
            ("start", "1", "1"): 6}
    check(start_forms == want, f"K1 start forms (root, bricks): {start_forms}, expected {want}")
    # The seed forms (phase 9d): a table for first descents only, primary
    # (visits none, counts, flags) and shadow mode (none, counts).
    want = {("0", "0"): 6, ("0", "1"): 6, ("1", "0"): 4, ("1", "1"): 4}
    check(seed_forms == want, f"K1 seed forms (shadow, root): {seed_forms}, expected {want}")
    # K1's counters (probes/k1_counters.py), built beside the next phases
    # for 9b and 9c: an instrumented copy of trace.cu in its own library.
    K1["counters_dir"] = tempfile.mkdtemp(prefix="ot_k1_counters_")
    K1["counters_build"] = k1_counters.start_build(REPO, K1["counters_dir"])

    # 3. The deep10 scene on the card.
    t0 = time.perf_counter()
    words_np = scenes.deep_shell(DEPTH)
    words = state.u32_to_device(words_np, dev)
    phase("3 scene", f"deep_shell({DEPTH}): {words_np.shape[0]} nodes, "
          f"{words_np.nbytes / 2**20:.1f} MiB pool, built in "
          f"{time.perf_counter() - t0:.1f} s")

    # 4. K2 against its plain version, exact: at level 7 (timed, and its
    #    bound recounted from the pool sectors the descents read), at every
    #    level from 0 to 9 on the deep10 pool and on the malformed pools
    #    (pointers past the end, a ragged last row); then K1 against its
    #    plain version on the malformed pools.
    warp_k, occ_k = tracer.warp_occupancy(words, LEVELS)
    warp_p, occ_p = tracer.warp_occupancy_plain(words, LEVELS)
    check(torch.equal(warp_k, warp_p) and torch.equal(occ_k, occ_p),
          "warp_occupancy kernel differs from its plain version")
    malformed = {k: state.u32_to_device(v, dev) for k, v in scenes.malformed_pools().items()}
    k2_cases = 0
    for lv in range(10):
        for name, pool in [("deep10", words), *malformed.items()]:
            got, want = tracer.warp_occupancy(pool, lv), tracer.warp_occupancy_plain(pool, lv)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"warp_occupancy kernel differs from its plain version on {name} at L{lv}")
            k2_cases += 1
        del got, want
    k2_bytes = tracer.k2_bytes(words, LEVELS)
    report["warp_occupancy"].update(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: tracer.warp_occupancy(words, LEVELS), 20),
        alone_ms=device_ms(lambda: tracer.warp_occupancy(words, LEVELS), 50),
        plain_ms=cuda_ms(lambda: tracer.warp_occupancy_plain(words, LEVELS), 3),
        library_ms=None,
        # A warp word and a flag a cell, and each 32-byte pool sector the
        # descents read, once (tracer.k2_bytes); the outputs alone beside.
        **bound(k2_bytes), k2_bytes=k2_bytes,
        outputs_bound_ms=bound(8 ** LEVELS * 5)["bound_ms"],
    )
    t0 = time.perf_counter()
    table = skip.build_warp_skip_table(words, LEVELS)
    torch.cuda.synchronize()
    r = report["warp_occupancy"]
    phase("4 K2", f"warp words and occupancy equal on {warp_k.numel()} cells; "
          f"{int(occ_k.sum())} occupied; equal to plain at every level 0-9 on deep{DEPTH} "
          f"and {sorted(malformed)} ({k2_cases} cases); kernel alone {r['alone_ms']:.5f} ms, "
          f"wrapper back to back {r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms ({k2_bytes} "
          f"bytes; outputs only {r['outputs_bound_ms']:.5f}), plain {r['plain_ms']:.3f} ms; "
          f"combined table {table.numel()} words in {time.perf_counter() - t0:.2f} s")
    phase("4 K1", malformed_trace_check(dev, malformed))
    skip_field_check(dev, report, words, malformed, occ_k, table, device_ms)

    # 5. K3 against its plain version on the bench camera, bit for bit, and
    #    on a width that is no multiple of 4 (the scalar tail); one call from
    #    a NumPy matrix, as Session.render makes it, must not synchronise.
    _, ci = camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)
    ci_t = torch.from_numpy(ci).to(dev)
    origin, dirs = camera.generate_rays_device(ci, W, H, dev)
    origin_p, dirs_p = camera.generate_rays_device_plain(ci_t, W, H)
    check(torch.equal(dirs, dirs_p) and torch.equal(origin, origin_p),
          f"raygen kernel differs from plain by {float((dirs - dirs_p).abs().max())}")
    tail_w, tail_h = 1917, 37
    tail = camera.generate_rays_device(ci, tail_w, tail_h, dev)
    tail_p = camera.generate_rays_device_plain(ci_t, tail_w, tail_h)
    check(all(torch.equal(a, b) for a, b in zip(tail, tail_p)),
          f"raygen kernel differs from plain at {tail_w}x{tail_h}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        camera.generate_rays_device(ci, W, H, dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    report["raygen"].update(
        max_abs_err=0.0,
        # The wrapper's calls back to back, host included, as the Session's
        # (ms, as for every kernel), and the kernel alone (its calls queued
        # behind a spin twice their enqueue time).
        ms=cuda_ms(lambda: camera.generate_rays_device(ci, W, H, dev), 50, 5),
        alone_ms=device_ms(lambda: camera.generate_rays_device(ci, W, H, dev), 50),
        plain_ms=cuda_ms(lambda: camera.generate_rays_device_plain(ci_t, W, H), 5),
        library_ms=None,
        **bound(W * H * 12 + 12 + 64),  # directions and origin out, the matrix in
    )
    r = report["raygen"]
    phase("5 K3", f"equal to plain over {W}x{H} rays and at {tail_w}x{tail_h}; a call "
          f"from a NumPy matrix ran under sync debug mode 'error'; kernel alone "
          f"{r['alone_ms']:.5f} ms, wrapper back to back {r['ms']:.5f} ms, bound "
          f"{r['bound_ms']:.5f} ms, plain {r['plain_ms']:.3f} ms")

    # 6. K1 against its plain version on the full primary wavefront, and
    #    against the NumPy oracle (no table) on a fixed subsample. The frame's
    #    call (image tiles, one stride-0 origin) against the flat call with
    #    contiguous origins, and the shadow mode against shadow_rays +
    #    trace_plain on every ray, culled and not.
    n = W * H
    flat = dirs.reshape(n, 3)
    origins = origin.reshape(1, 3).expand(n, 3)  # stride 0, as render_frame
    origins_c = origins.contiguous()
    res_k = tracer.trace(words, origins, dirs, warp_table=table)
    res_lin = tracer.trace(words, origins_c, flat, warp_table=table)
    check(all(torch.equal(x, y) for x, y in zip(res_k, res_lin)),
          "trace: the tiled stride-0 call differs from the flat contiguous call")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_p = tracer.trace_plain(words, origins_c, flat, warp_table=table)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    a_k, a_p = tracer.to_numpy(res_k), tracer.to_numpy(res_p)
    agree = tracer.agreement(a_k, a_p)
    hp_err = float(np.abs(a_k["hit_pos"] - a_p["hit_pos"])[agree].max())
    frac = float((~agree).mean())
    check(frac < 0.005, f"trace kernel disagrees with plain on {frac:.4%} of rays")
    check(hp_err <= 1e-5, f"trace hit_pos differs from plain by {hp_err}")
    sh_k = tracer.trace_shadow(words, res_k, warp_table=table, image_width=W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh_p = tracer.trace_plain(words, *tracer.shadow_rays(res_k), warp_table=table).hit
    torch.cuda.synchronize()
    sh_plain_s = time.perf_counter() - t0
    sh_all = tracer.trace_shadow(words, res_k, cull=False, warp_table=table, image_width=W)
    sh_all_p = tracer.trace_plain(words, *tracer.shadow_rays(res_k, cull=False),
                                  warp_table=table).hit
    sh_diff = int((sh_k != sh_p).sum()) + int((sh_all != sh_all_p).sum())
    check(sh_diff == 0, f"trace_shadow differs from shadow_rays + trace_plain on {sh_diff} rays")
    # Loop trips, and the 32-byte pool rows they read: the count-mode visits
    # of the same rays.
    trips_v = torch.zeros(words.shape[0], dtype=torch.int32, device=dev)
    tracer.trace(words, origins, dirs, warp_table=table, visits=trips_v)
    sh_trips_v = torch.zeros_like(trips_v)
    tracer.trace_shadow(words, res_k, warp_table=table, visits=sh_trips_v, image_width=W)
    trips, sh_trips = int(trips_v.sum()), int(sh_trips_v.sum())
    rows, sh_rows = tracer.touched_rows(trips_v), tracer.touched_rows(sh_trips_v)
    prim_hits = int(res_k.hit.sum())
    sh_active = int(tracer.shadow_rays(res_k)[2].sum())
    report["trace"].update(
        max_abs_err=hp_err,
        ms=cuda_ms(lambda: tracer.trace(words, origins, dirs, warp_table=table), TIMED),
        plain_ms=plain_s * 1e3,
        library_ms=None,
        # Each byte the kernel must move, once: every pool row the rays touch
        # (a trip that reads a row again finds it in L2; the table's reads
        # are not counted), the one origin, each ray's direction in and 42
        # bytes of results out.
        trips=trips, rows=rows, **bound(tracer.k1_bytes(rows, n)),
        linear_ms=cuda_ms(lambda: tracer.trace(words, origins_c, flat, warp_table=table),
                          TIMED),
        # The shadow mode: the rows its rays touch, each ray's primary hit in
        # and shadow hit out, each primary hit's normal (the cull test) and
        # each traced shadow ray's hit_pos.
        shadow_ms=cuda_ms(lambda: tracer.trace_shadow(words, res_k, warp_table=table,
                                                      image_width=W), TIMED),
        shadow_plain_ms=sh_plain_s * 1e3, shadow_trips=sh_trips, shadow_rows=sh_rows,
        shadow_bound_ms=bound(tracer.k1_shadow_bytes(sh_rows, n, prim_hits + sh_active))[
            "bound_ms"],
    )
    sample = np.sort(np.random.default_rng(0).choice(n, ORACLE_RAYS, replace=False))
    res_0 = tracer.to_numpy(tracer.trace(words, origins, flat))
    res_o = cpu_reference.trace_rays(words_np, origin.cpu().numpy(),
                                     flat.cpu().numpy()[sample])
    agree_o = tracer.agreement({f: v[sample] for f, v in res_0.items()}, res_o)
    frac_o = float((~agree_o).mean())
    hp_o = float(np.abs(res_0["hit_pos"][sample] - res_o["hit_pos"])[agree_o].max())
    check(frac_o < 0.005, f"trace kernel disagrees with the oracle on {frac_o:.4%}")
    check(hp_o <= 1e-5, f"trace hit_pos differs from the oracle by {hp_o}")
    r = report["trace"]
    phase("6 K1", f"kernel vs plain (combined L{LEVELS}): {int((~agree).sum())} of "
          f"{n} rays disagree ({frac:.6f}), hit_pos max {hp_err:.3g}; kernel "
          f"(no table) vs oracle: {int((~agree_o).sum())} of {ORACLE_RAYS} "
          f"({frac_o:.6f}), hit_pos max {hp_o:.3g}; tiled stride-0 call equal to the "
          f"flat contiguous call; shadow mode equal to shadow_rays + trace_plain on "
          f"{n} rays culled and not ({int(sh_k.sum())} / {int(sh_all.sum())} shadowed); "
          f"hits {int(a_k['hit'].sum())}; primary {r['ms']:.4f} ms (flat order "
          f"{r['linear_ms']:.4f}), {trips} trips over {rows} rows, bound {r['bound_ms']:.4f} "
          f"ms; shadow {r['shadow_ms']:.4f} ms, {sh_active} of {prim_hits} hits traced, "
          f"{sh_trips} trips over {sh_rows} rows, bound {r['shadow_bound_ms']:.4f} ms; "
          f"plain {plain_s * 1e3:.1f} / {sh_plain_s * 1e3:.1f} ms")

    # 7. K4 against its plain version on the frame's own inputs, in every
    #    view (shaded, show_steps, gamma 1.0; show_hits in phase 9), u8 and
    #    f32; on 1917x37 rays, on views one element off 16 bytes and on
    #    views whose inputs start at different elements, each also equal to
    #    the full call's pixels. The u8 encode is a search of thresholds
    #    that the powf encode defines: it must give the powf encode's byte
    #    on every f32 in [0, 1], and the powf encode must not decrease
    #    between neighbouring values there.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    differ, decrease, compared = tracer.encode_check(dev)
    check_s = time.perf_counter() - t0
    check(compared == tracer.ENCODE_CHECK_VALUES, f"encode check compared {compared} f32 "
          f"values, not the {tracer.ENCODE_CHECK_VALUES} in [0, 1]")
    check(differ == 0 and decrease == 0, f"encode search differs from the powf encode on "
          f"{differ} f32 values in [0, 1]; the powf encode decreases {decrease} times")
    phase("7 K4", f"threshold encode equal to the powf encode on the {compared:,} f32 "
          f"values the check counted (every one in [0, 1]), the powf encode "
          f"non-decreasing there ({check_s:.2f} s)")
    shadow_hit = sh_k

    def shade_check(r, sh, what, **kw):
        img_k = tracer.shade(r, sh, **kw)
        img_p = tracer.shade_plain(r, sh, **kw)
        err = float((img_k - img_p).abs().max())
        u8_k = tracer.shade(r, sh, u8=True, **kw)
        u8_diff = (u8_k.int() - tracer.encode_u8_plain(img_p).int()).abs()
        frac, worst = float((u8_diff == 0).float().mean()), int(u8_diff.max())
        check(err <= 1e-6, f"shade {what}: f32 differs from plain by {err}")
        check(frac >= 0.999 and worst <= 1,
              f"shade {what}: u8 equal on {frac:.5f}, max diff {worst}")
        return img_k, u8_k, err, frac, worst

    img_k, u8_k, img_err, u8_frac, u8_worst = shade_check(res_k, shadow_hit, "frame")
    errs = [shade_check(res_k, shadow_hit, "show_steps", show_steps=True)[2],
            shade_check(res_k, shadow_hit, "gamma 1.0", gamma=1.0)[2],
            shade_check(res_k, None, "no shadows")[2]]
    small = 1917 * 37
    for what, first in (("1917x37", 0), ("one element off 16 bytes", 1),
                        ("inputs off by different elements", None)):
        # Field k of the last view starts k elements in; the shadow mask 2.
        starts = [k if first is None else first for k in range(len(res_k) + 1)]
        r_v = tracer.TraceResult(*(t[a:a + small] for t, a in zip(res_k, starts)))
        sh_v = shadow_hit[starts[2]:starts[2] + small]
        f_v, b_v, err, _, _ = shade_check(r_v, sh_v, what)
        errs.append(err)
        if first is not None:
            check(torch.equal(f_v, img_k[first:first + small])
                  and torch.equal(b_v, u8_k[first:first + small]),
                  f"shade {what}: differs from the full call's pixels")
    lit = res_k.hit & ~res_k.forced
    report["shade_encode"].update(
        encode_values_checked=compared, encode_differ=differ, encode_decreases=decrease,
        max_abs_err=max([img_err] + errs),
        ms=cuda_ms(lambda: tracer.shade(res_k, shadow_hit, u8=True), 20),
        alone_ms=device_ms(lambda: tracer.shade(res_k, shadow_hit, u8=True), 50),
        f32_alone_ms=device_ms(lambda: tracer.shade(res_k, shadow_hit), 50),
        plain_ms=cuda_ms(lambda: tracer.encode_u8_plain(
            tracer.shade_plain(res_k, shadow_hit)), 5),
        library_ms=None, lit=int(lit.sum()),
        # Two masks in and the u8 frame out, a ray; each 32-byte sector of
        # shadow_hit, word and normal that holds a lit pixel's entry
        # (tracer.k4_bytes).
        # The earlier count, 26 bytes a ray (every input, steps included),
        # stays beside it.
        **bound(tracer.k4_bytes(lit, 3)),
        f32_bound_ms=bound(tracer.k4_bytes(lit, 12))["bound_ms"],
        all_rays_bound_ms=bound(n * 26)["bound_ms"],
    )
    r = report["shade_encode"]
    phase("7 K4", f"f32 max |kernel - plain| {img_err:.3g}; u8 equal on "
          f"{u8_frac:.6f} of channels, max diff {u8_worst}; show_steps, gamma 1.0 and "
          f"no-shadow views, 1917x37 rays, a view one element off 16 bytes and inputs "
          f"off by different elements within the same rules (f32 max {max(errs):.3g}), "
          f"the cut views equal to the full call's pixels; {r['lit']} lit pixels; kernel "
          f"alone {r['alone_ms']:.5f} ms (u8), {r['f32_alone_ms']:.5f} ms (f32); wrapper "
          f"back to back {r['ms']:.5f} ms (u8); bound {r['bound_ms']:.5f} ms (u8; f32 "
          f"{r['f32_bound_ms']:.5f}; the earlier 26 B a ray "
          f"{r['all_rays_bound_ms']:.5f}); plain {r['plain_ms']:.3f} ms")

    # 8. The main path once, counted: table build, raygen, shadowed frame.
    kernels.reset_launches()
    table = skip.build_warp_skip_table(words, LEVELS)
    origin, dirs = camera.generate_rays_device(ci, W, H, dev)
    img, res, _ = tracer.render_frame(words, origin, dirs, shadows=True,
                                      warp_table=table, u8_image=True)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in FRAME_KERNELS}
    hits = int(res.hit.sum())
    check(all(v > 0 for v in launches.values()), f"a kernel never ran: {launches}")
    check(img.shape == (H, W, 3) and img.dtype == torch.uint8, "bad frame")
    check(0 < hits < n, f"implausible hit count {hits}")
    for k, v in launches.items():
        report[k]["frame_launches"] = v

    def frame(shadows):
        return tracer.render_frame(words, origin, dirs, shadows=shadows,
                                   warp_table=table, u8_image=True)

    ms_sh = cuda_ms(lambda: frame(True), TIMED, WARMUP)
    ms_pr = cuda_ms(lambda: frame(False), TIMED, WARMUP)
    power = nvidia_smi("clocks.sm,power.draw,power.limit")
    by_kernel, busy = profile_frames(lambda: frame(True), PROFILED)

    # The same frame through the plain versions on the card, once.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_p = tracer.trace_plain(words, origins_c, flat, warp_table=table)
    sh_p = tracer.trace_plain(words, *tracer.shadow_rays(res_p), warp_table=table)
    img_p = tracer.encode_u8_plain(tracer.shade_plain(res_p, sh_p.hit))
    torch.cuda.synchronize()
    plain_frame_ms = (time.perf_counter() - t0) * 1e3
    px_equal = float(torch.all(img.reshape(n, 3) == img_p, dim=1).float().mean())
    check(px_equal >= 0.995, f"frame equals the plain frame on {px_equal:.5f}")
    phase("8 frame", f"{card}: deep{DEPTH} {W}x{H} shadows + combined L{LEVELS} "
          f"u8: {ms_sh:.3f} ms/frame, {(n + hits) / ms_sh / 1e3:.2f} Mrays/s "
          f"((W*H + hits)/t); primaries only {ms_pr:.3f} ms/frame, "
          f"{n / ms_pr / 1e3:.2f} Mrays/s; hits {hits}; launches {launches}; "
          f"plain frame {plain_frame_ms:.1f} ms; pixels equal to plain "
          f"{px_equal:.6f}; clocks.sm,power.draw,power.limit {power}")
    profile = "; ".join(f"{k[:60]} {ms:.4f}" for k, ms in by_kernel[:8])
    phase("8 profile", f"torch.profiler over {PROFILED} shadowed frames, device ms a "
          f"frame by kernel: {profile}; device busy {busy:.3f} of the window from "
          f"the first kernel's start to the last one's end")

    ref = session_phases(dev, report, words, words_np, origins, dirs, table, res_k, ci, card)
    gen_phases(dev, report, card)
    probe_phase(dev, report)
    app_phases(dev, report, card)
    sharded_phases(dev, report, card, words, table, ci, ref)

    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def session_phases(dev, report, words, words_np, origins, dirs, table, res_k, ci,
                   card) -> list:
    """Phases 9-12: visit marking, candidate selection and the visit closure
    against their plain versions, then the Session on the card. Returns
    phase 11's step records (``step_record``), which phase 22 holds the
    sharded Sessions to."""
    from octree_tracer_tpu_torch import kernels, scenes, state
    from octree_tracer_tpu_torch.adaptive import feedback
    from octree_tracer_tpu_torch.app.session import Session
    from octree_tracer_tpu_torch.probes.gather_probe import cuda_ms as device_ms
    from octree_tracer_tpu_torch.render import tracer

    n_words = words.shape[0]

    # 9. K1 with visits (counts and flags) against trace_plain, on the
    #    deep10 1080p primaries with the combined table, called as the frame
    #    calls it; the shadow mode's counts on all hits (a counted frame's
    #    shadow pass); K4's show_hits view.
    flat = dirs.reshape(-1, 3)
    marks = {}
    for mode, flags in (("counts", False), ("flags", True)):
        v_k = torch.zeros(n_words, dtype=torch.int32, device=dev)
        v_p = torch.zeros_like(v_k)
        r_k = tracer.trace(words, origins, dirs, warp_table=table, visits=v_k,
                           visit_flags=flags)
        r_p = tracer.trace_plain(words, origins, flat, warp_table=table, visits=v_p,
                                 visit_flags=flags)
        check(torch.equal(r_k.index, r_p.index), f"trace {mode}: index differs")
        check(torch.equal(v_k, v_p), f"trace {mode}: visits differ from plain on "
              f"{int((v_k != v_p).sum())} slots")
        marks[mode] = v_k
    counts, flags = marks["counts"], marks["flags"]
    check(torch.equal(flags, (counts > 0).int()), "flags are not counts > 0")
    sh_k = torch.zeros(n_words, dtype=torch.int32, device=dev)
    sh_p = torch.zeros_like(sh_k)
    tracer.trace_shadow(words, res_k, cull=False, warp_table=table, visits=sh_k,
                        image_width=W)
    tracer.trace_plain(words, *tracer.shadow_rays(res_k, cull=False), warp_table=table,
                       visits=sh_p)
    check(torch.equal(sh_k, sh_p), f"trace_shadow counts differ from plain on "
          f"{int((sh_k != sh_p).sum())} slots")
    buf = torch.zeros(n_words, dtype=torch.int32, device=dev)
    t_plain = cuda_ms(lambda: tracer.trace(words, origins, dirs, warp_table=table), TIMED)
    t_counts = cuda_ms(lambda: tracer.trace(words, origins, dirs, warp_table=table,
                                            visits=buf), TIMED)
    t_flags = cuda_ms(lambda: tracer.trace(words, origins, dirs, warp_table=table,
                                           visits=buf, visit_flags=True), TIMED)
    t_sh_counts = cuda_ms(lambda: tracer.trace_shadow(
        words, res_k, cull=False, warp_table=table, visits=buf, image_width=W), TIMED)
    report["trace"].update(visits_exact=True, unmarked_ms=t_plain, counts_ms=t_counts,
                           flags_ms=t_flags, shadow_counts_ms=t_sh_counts)
    img_k = tracer.shade(res_k, hits_visits=counts)
    img_p = tracer.shade_plain(res_k, hits_visits=counts)
    hits_err = float((img_k - img_p).abs().max())
    check(hits_err <= 1e-6, f"show_hits view differs from plain by {hits_err}")
    hits_u8 = (tracer.shade(res_k, hits_visits=counts, u8=True).int()
               - tracer.encode_u8_plain(img_p).int()).abs()
    hits_frac = float((hits_u8 == 0).float().mean())
    check(hits_frac >= 0.999 and int(hits_u8.max()) <= 1,
          f"show_hits u8: {hits_frac:.5f} equal, max diff {int(hits_u8.max())}")
    report["shade_encode"].update(show_hits_err=hits_err)
    phase("9 K1 visits", f"counts and flags equal to plain on {n_words} slots "
          f"({int((counts > 0).sum())} marked, {int(counts.sum())} marks), shadow-mode "
          f"counts equal ({int(sh_k.sum())} marks); K1 unmarked {t_plain:.4f} ms, counts "
          f"{t_counts:.4f} ms, flags {t_flags:.4f} ms, shadow counts {t_sh_counts:.4f} ms; "
          f"K4 show_hits f32 max |kernel - plain| {hits_err:.3g}, u8 equal on "
          f"{hits_frac:.6f}")
    root_restart_phase(dev, report, words, origins, dirs, table, res_k, card)
    bricks_pages_phase(dev, report, words, words_np, origins, dirs, table, res_k, ci, card)
    schedules_phase(dev, report, words, origins, dirs, table, res_k, ci, card)

    # 10. K5 and K6 against their plain versions on phase 9's visits. K5
    #     exactly equal at phase 10's two shapes (caps 65536, the Session's,
    #     and an overflow of caps 1024), at every offset residue mod 4 and at
    #     n - 1, for caps of 0, for node_len < n, for n under one tile, for n
    #     no multiple of 4 and on views off 16 bytes (scalar loads).
    def select_check(w, v, node_len, sub_cap, unsub_cap, offset, what):
        args = (w, v, node_len, sub_cap, unsub_cap, offset)
        out_k = feedback.select_candidates_packed(*args)
        out_p = feedback.select_candidates_plain(*args)
        check(torch.equal(out_k, out_p), f"select_candidates {what} (caps {sub_cap}/"
              f"{unsub_cap}, offset {offset}, n {w.shape[0]}, node_len {node_len}) differs "
              f"from plain on {int((out_k != out_p).sum())} entries")
        return out_k

    for sub_cap, unsub_cap, offset in ((65536, 65536, 123457), (1024, 1024, 777)):
        args = (words, counts, n_words, sub_cap, unsub_cap, offset)
        out_k = select_check(*args, "phase shape")
        over = int(out_k[0]) > sub_cap or int(out_k[1]) > unsub_cap
        alone_ms = device_ms(lambda: feedback.select_candidates_packed(*args), 50)
        ms_k = cuda_ms(lambda: feedback.select_candidates_packed(*args), 20)
        ms_p = cuda_ms(lambda: feedback.select_candidates_plain(*args), 5)
        if sub_cap == 65536:
            report["select_candidates"].update(
                max_abs_err=0.0, ms=ms_k, alone_ms=alone_ms, plain_ms=ms_p,
                library_ms=None,
                **bound(feedback.select_bytes(n_words, sub_cap, unsub_cap)))
        phase("10 K5", f"caps {sub_cap}/{unsub_cap} offset {offset}: equal; sub_n "
              f"{int(out_k[0])}, unsub_n {int(out_k[1])}, overflow {over}; kernel alone "
              f"{alone_ms:.5f} ms, wrapper back to back {ms_k:.5f} ms, plain {ms_p:.3f} ms")
    r = report["select_candidates"]
    phase("10 K5", f"bound {r['bound_ms']:.5f} ms ({n_words} slots, caps 65536/65536)")
    edges = 0
    tile = feedback.SELECT_TILE
    for offset in (0, 1, 2, 3, 4097, 123458, 123459, 123460, n_words - 1):
        select_check(words, counts, n_words, 65536, 65536, offset, "offset")
        edges += 1
    for caps in ((0, 0), (0, 65536), (65536, 0), (7, 3)):
        select_check(words, counts, n_words, *caps, 5, "caps")
        edges += 1
    select_check(words, counts, n_words // 3 + 1, 65536, 65536, 777, "node_len < n")
    small_n = (1000, tile - 1, tile, tile + 1, 3 * tile + 5, 1_000_003)
    for m in small_n:
        for offset in (0, m // 2 + 1, m - 1):
            select_check(words[:m], counts[:m], m, 64, 64, offset, "short pool")
            select_check(words[:m], counts[:m], m - m // 4, 3, 3, offset, "short pool")
            edges += 2
    for lo in (1, 2, 3):
        m = 2 * tile + 7
        select_check(words[lo:lo + m], counts[lo:lo + m], m, 500, 500, 11,
                     "view off 16 bytes")
        select_check(words[lo:lo + m], counts[4:4 + m], m, 500, 500, 0,
                     "views off 16 bytes by different elements")
        edges += 2
    phase("10 K5", f"{edges + 1} edge cases equal to plain: offsets 0-3, 4097, "
          f"123458-123460 and n - 1; caps 0/0, 0/65536, 65536/0 and 7/3; node_len "
          f"n/3 + 1; pools of {', '.join(map(str, small_n))} slots (one tile is {tile}), "
          f"each from three offsets and with node_len < n; views off 16 bytes")
    passes = DEPTH + 1
    closed_k = feedback.propagate_visits(words, flags, passes)
    closed_p = feedback.propagate_visits_plain(words, flags, passes)
    err = int((closed_k - closed_p).abs().max())
    check(err == 0, f"propagate_visits differs from plain by {err}")
    ms_k = cuda_ms(lambda: feedback.propagate_visits(words, flags, passes), 10)
    ms_p = cuda_ms(lambda: feedback.propagate_visits_plain(words, flags, passes), 3)
    report["propagate_visits"].update(max_abs_err=float(err), ms=ms_k, plain_ms=ms_p,
                                      library_ms=None, passes=passes,
                                      # Each pass: words, visits in; visits out.
                                      **bound(passes * n_words * 12))
    phase("10 K6", f"{passes} passes equal to plain; {int((closed_k != flags).sum())} "
          f"interiors closed; kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms (all passes)")

    # 11. The Session on the card: deep10 shell world, 1080p, bench camera,
    #     shipped defaults (deferred feedback, flags, feedback every frame,
    #     the skip half on), in lockstep with a twin on the plain skip path.
    t0 = time.perf_counter()
    world = scenes.shell_world(DEPTH)
    sess = Session(world, W, H, device=dev)
    sess.character.pos = CAM_POS.copy()
    sess.character.look = CAM_LOOK.copy()
    sess.settings.fov = FOV
    check(sess.use_native, "the native host engine did not build")
    setup_s = time.perf_counter() - t0
    # Its twin builds every skip half on the plain path (K2's occupancy to
    # the host, the NumPy build); its launches are not counted.
    twin = plain_skip_session(scenes.shell_world(DEPTH), W, H, device=dev)
    twin.character.pos, twin.character.look = CAM_POS.copy(), CAM_LOOK.copy()
    twin.settings.fov = FOV
    kernels.reset_launches()
    step_ms, rode, warped_steps, ref = [], 0, [], []
    totals = {"subdivided": 0, "collapsed": 0, "patched": 0}
    tables = 0
    for i in range(SESSION_STEPS):
        t0 = time.perf_counter()
        img, _, stats = sess.step()
        host = img.cpu()  # the viewer's u8 frame fetch
        step_ms.append((time.perf_counter() - t0) * 1e3)
        ref.append(step_record(sess, host, stats, step_ms[-1]))
        if sess._frame_warped:
            rode += 1
            warped_steps.append(i)
        for k in totals:
            totals[k] += stats[k]
        counted = dict(kernels.LAUNCHES)
        img_p, _, stats_p = twin.step()
        kernels.LAUNCHES.update(counted)
        a, b = sess._warp_table, twin._warp_table
        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
              f"step {i}: the table differs from the plain-path twin's")
        check(stats == stats_p and torch.equal(img, img_p),
              f"step {i}: the frame or stats differ from the plain-path twin's")
        tables += a is not None
    check(tables > 0, "no step had a table")
    del twin
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in SESSION_KERNELS}
    for k, v in launches.items():
        report[k]["launches"] = v
    n_nodes, holes = sess.node_stats()
    pool = state.to_numpy_u32(sess.device_words)
    check(np.array_equal(pool[:n_nodes], sess.octree.nodes) and not pool[n_nodes:].any(),
          "the device pool differs from the host octree")
    check(rode > 0, f"no counted frame rode the table (bucket "
          f"{sess.device_words.shape[0]}, {n_nodes} nodes)")
    check(all(v > 0 for v in launches.values()),
          f"a kernel never ran on the Session path: {launches}")
    check(img.shape == (H, W, 3) and totals["subdivided"] > 0, "the Session did not grow")
    phase("11 session", f"{card}: deep{DEPTH} shell world {W}x{H}, setup "
          f"{setup_s:.1f} s, engine {'native' if sess.use_native else 'python'}; "
          f"{SESSION_STEPS} steps, median step {float(np.median(step_ms)):.1f} ms "
          f"(last 8: {float(np.median(step_ms[-8:])):.1f} ms, max {max(step_ms):.1f}); "
          f"bucket {sess.device_words.shape[0]}, nodes {n_nodes}, holes {holes:.2f}%, "
          f"max depth {sess.octree.max_depth}; totals {totals}; counted frames on "
          f"the table {rode} (steps {warped_steps}); stale dropped "
          f"{sess.stale_dropped}; launches {launches}; tables equal to the plain-path "
          f"twin's at {tables} steps; step ms "
          f"{[round(t, 1) for t in step_ms]}")
    del sess, world

    # 12. A CPU Session (plain versions) and a CUDA Session (kernels) in
    #     lockstep; the table from the first frame, so K2 and K6 take part.
    base = state.world_to_numpy(scenes.shell_world(LOCK_DEPTH))
    pair = [Session(state.world_from_numpy(base), *LOCK_RES, device=d)
            for d in ("cpu", dev)]
    for s_ in pair:
        s_.character.pos = LOCK_POS.copy()
        s_.character.look = LOCK_LOOK.copy()
        s_.settings.fov = FOV
        s_.settings.warp_pool_words = 1
    lock_totals = {"subdivided": 0, "collapsed": 0, "patched": 0}
    for i in range(LOCK_STEPS):
        if i == LOCK_TURN:
            for s_ in pair:
                s_.character.turn(900.0, 300.0, fov=FOV)
        (img_c, _, st_c), (img_g, _, st_g) = (s_.step() for s_ in pair)
        check(torch.equal(img_c, img_g.cpu()), f"lockstep step {i}: images differ on "
              f"{int((img_c != img_g.cpu()).any(-1).sum())} pixels")
        check(st_c == st_g, f"lockstep step {i}: stats {st_c} vs {st_g}")
        check(torch.equal(pair[0].device_words, pair[1].device_words.cpu()),
              f"lockstep step {i}: pools differ")
        for k in lock_totals:
            lock_totals[k] += st_c[k]
    check(lock_totals["subdivided"] > 0 and lock_totals["collapsed"] > 0,
          f"the lockstep did not grow and collapse: {lock_totals}")
    phase("12 lockstep", f"CPU and CUDA Sessions equal at every step: shell "
          f"depth {LOCK_DEPTH}, {LOCK_RES[0]}x{LOCK_RES[1]}, {LOCK_STEPS} steps, "
          f"totals {lock_totals}, nodes {len(pair[1].octree)}, counted frames "
          f"on the table {pair[1]._frame_warped}")
    return ref


def root_restart_phase(dev, report, words, origins, dirs, table, res_k, card) -> None:
    """Phase 9b: K1's root-restart form (``parent_restart=False``, the
    reference's full re-descent) on the deep10 1080p primaries, without a
    table and with the combined table: counts, flags (the plain counts'
    nonzero set) and the shadow mode's counts equal to the plain version on
    every field and slot, every field equal to the counting parent form's
    (with the combined table a counted jump counts a root descent's steps,
    where phase 6's uncounted pass counts one), the primary pass timed alone
    in both forms in turn; then the counted frame in the root form, its
    launches counted and its visits equal to the passes' counts."""
    from octree_tracer_tpu_torch import kernels
    from octree_tracer_tpu_torch.probes.gather_probe import cuda_ms as device_ms
    from octree_tracer_tpu_torch.probes.gather_probe import time_in_turn
    from octree_tracer_tpu_torch.render import tracer

    n_words, n = words.shape[0], W * H
    flat = dirs.reshape(-1, 3)
    # A descent passes a slot of a well-formed pool at most once, and a ray
    # descends at most MAX_STEPS + 1 times a pass: the bound of any slot's
    # count over a counted frame's two passes.
    count_cap = 2 * n * (tracer.MAX_STEPS + 1)
    check(count_cap < 2 ** 31, f"a slot's count can reach {count_cap}, past int32")
    entry = {}
    for what, t in (("none", None), ("combined", table)):
        kw = dict(warp_table=t, parent_restart=False)
        parent = tracer.trace(words, origins, dirs, warp_table=t,
                              visits=torch.zeros(n_words, dtype=torch.int32, device=dev))
        plain_s, errs, exact = {}, [], []
        v_p = torch.zeros(n_words, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_p = tracer.trace_plain(words, origins, flat, visits=v_p, **kw)
        torch.cuda.synchronize()
        plain_s["counts"] = time.perf_counter() - t0
        # The plain version's flags are its counts' nonzero set (the same
        # trips mark the same slots).
        for mode, flags, want in (("counts", False, v_p), ("flags", True, (v_p > 0).int())):
            v_k = torch.zeros(n_words, dtype=torch.int32, device=dev)
            r_k = tracer.trace(words, origins, dirs, visits=v_k, visit_flags=flags, **kw)
            differ = [f for f, a, b in zip(r_k._fields, r_k, r_p) if not torch.equal(a, b)]
            check(not differ, f"root restart, {what} table, {mode}: {differ} differ from plain")
            check(torch.equal(v_k, want), f"root restart, {what} table, {mode}: visits differ "
                  f"from plain on {int((v_k != want).sum())} slots")
            errs.append(max_abs_err(zip(r_k, r_p)))
            exact.append(torch.equal(v_k, want))
            differ = [f for f, a, b in zip(r_k._fields, r_k, parent) if not torch.equal(a, b)]
            check(not differ, f"root restart, {what} table: {differ} differ from the parent "
                  f"form")
        counts = v_p
        sh_k = torch.zeros(n_words, dtype=torch.int32, device=dev)
        sh_p = torch.zeros_like(sh_k)
        hit_k = tracer.trace_shadow(words, r_k, cull=False, visits=sh_k, image_width=W, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit_p = tracer.trace_plain(words, *tracer.shadow_rays(r_k, cull=False), visits=sh_p,
                                   **kw).hit
        torch.cuda.synchronize()
        plain_s["shadow"] = time.perf_counter() - t0
        check(torch.equal(hit_k, hit_p) and torch.equal(sh_k, sh_p),
              f"root restart, {what} table: the shadow mode differs from plain")
        errs.append(max_abs_err([(hit_k, hit_p)]))
        exact.append(torch.equal(sh_k, sh_p))
        culled = tracer.trace_shadow(words, r_k, image_width=W, **kw)
        check(torch.equal(culled, tracer.trace_shadow(words, parent, warp_table=t,
                                                      image_width=W)),
              f"root restart, {what} table: the culled shadow mask differs from the parent "
              f"form's")
        max_count = int((counts + sh_k).max())
        check(max_count <= count_cap, f"a slot counted {max_count} > {count_cap}")
        rows = tracer.touched_rows(counts)
        times = time_in_turn({
            "root": lambda: tracer.trace(words, origins, dirs, **kw),
            "parent": lambda: tracer.trace(words, origins, dirs, warp_table=t)}, 5, 10)
        buf = torch.zeros(n_words, dtype=torch.int32, device=dev)
        # The latency bound (the longest ray's trips), and the visit atomics
        # a counted pass issues (the instrumented copy), against the parent
        # form's on the same rays.
        lat = latency_bound(lambda c: tracer.trace(words, origins, dirs, max_iters=c, **kw),
                            r_k)
        atomics = {}
        with counters() as c:
            for form, call in (
                    ("root", lambda: tracer.trace(words, origins, dirs, visits=buf, **kw)),
                    ("parent", lambda: tracer.trace(words, origins, dirs, visits=buf,
                                                    warp_table=t)),
                    ("shadow", lambda: tracer.trace_shadow(words, r_k, cull=False, visits=buf,
                                                           image_width=W, **kw))):
                buf.zero_()
                call()
                atomics[form] = c.read()["atomics"]
        marked = int((counts > 0).sum())
        entry[what] = dict(
            max_abs_err=max(errs), visits_exact=all(exact),
            alone_ms=times["root"]["median"], alone_range=times["root"]["range"],
            parent_alone_ms=times["parent"]["median"],
            parent_alone_range=times["parent"]["range"],
            ms=cuda_ms(lambda: tracer.trace(words, origins, dirs, **kw), TIMED),
            counts_ms=cuda_ms(lambda: tracer.trace(words, origins, dirs, visits=buf, **kw),
                              TIMED),
            flags_ms=cuda_ms(lambda: tracer.trace(words, origins, dirs, visits=buf,
                                                  visit_flags=True, **kw), TIMED),
            shadow_ms=device_ms(lambda: tracer.trace_shadow(words, r_k, image_width=W, **kw),
                                10),
            shadow_counts_ms=cuda_ms(lambda: tracer.trace_shadow(
                words, r_k, cull=False, visits=buf, image_width=W, **kw), TIMED),
            plain_ms=plain_s["counts"] * 1e3, shadow_plain_ms=plain_s["shadow"] * 1e3,
            trips=int(counts.sum()), shadow_trips=int(sh_k.sum()), rows=rows,
            max_slot_count=max_count, library_ms=None, marked_slots=marked,
            atomics=atomics["root"], parent_atomics=atomics["parent"],
            shadow_atomics=atomics["shadow"],
            # The counting pass's bytes add each marked slot read and written.
            counts_bound_ms=bound(tracer.k1_bytes(rows, n, marked))["bound_ms"], **lat,
            # As phase 6's primary: every pool row the root form's rays touch,
            # the origin, each direction in and 42 bytes of results out.
            **bound(tracer.k1_bytes(rows, n)))
        e = entry[what]
        phase("9b K1 root restart", f"{card}: deep{DEPTH} {W}x{H}, {what} table: counts, "
              f"flags and shadow counts equal to plain on every field and all {n_words} "
              f"slots; every field and the culled shadow mask equal to the parent form's; "
              f"{e['trips']} trips ({e['shadow_trips']} shadow) over {rows} rows, largest "
              f"slot count {max_count} (cap {count_cap}); primary alone root "
              f"{e['alone_ms']:.4f} ms {e['alone_range']}, parent {e['parent_alone_ms']:.4f} "
              f"ms {e['parent_alone_range']} (in turn); root wrapper {e['ms']:.4f}, counts "
              f"{e['counts_ms']:.4f}, flags {e['flags_ms']:.4f}, shadow alone "
              f"{e['shadow_ms']:.4f}, shadow counts {e['shadow_counts_ms']:.4f} ms; bound "
              f"{e['bound_ms']:.4f} ms, counting {e['counts_bound_ms']:.4f} ms ({marked} "
              f"slots marked), latency {e['latency_bound_ms']:.4f} ms (longest ray "
              f"{e['longest_trips']} trips x {e['trip_ns']:.1f} ns); visit atomics a counted "
              f"pass {atomics['root']} (parent form {atomics['parent']}, shadow counts "
              f"{atomics['shadow']}) for {e['trips']} marks; plain counts "
              f"{e['plain_ms']:.0f} ms, shadow counts {e['shadow_plain_ms']:.0f} ms")
        if t is not None:
            frame_visits = counts + sh_k

    # The slice's path: the counted frame in the root form, through
    # render_frame, launches counted from zero.
    kernels.reset_launches()
    img_r, res_r, vis_r = tracer.render_frame(words, origins[0], dirs, warp_table=table,
                                              u8_image=True, with_visits=True,
                                              parent_restart=False)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in FRAME_KERNELS}
    check(launches["trace"] == 2 and launches["shade_encode"] == 1,
          f"the root-restart frame's launches: {launches}")
    # The counted frame in the parent form: a counted jump counts a root
    # descent's steps, so an uncounted frame may force fewer rays.
    img_0, _, _ = tracer.render_frame(words, origins[0], dirs, warp_table=table, u8_image=True,
                                      with_visits=True)
    check(torch.equal(img_r, img_0), "the root-restart frame differs from the parent form's")
    check(torch.equal(vis_r, frame_visits), "the root-restart frame's visits differ from its "
          "passes' counts")
    frame_ms = cuda_ms(lambda: tracer.render_frame(
        words, origins[0], dirs, warp_table=table, u8_image=True, with_visits=True,
        parent_restart=False), TIMED, WARMUP)
    regs = {k: v for k, v in K1["registers"].items()
            if "root=1" in k and "visits=0" not in k}
    report["trace"]["root_restart"] = dict(entry, frame_launches=launches["trace"],
                                           counted_frame_ms=frame_ms, registers=regs)
    phase("9b K1 root restart", f"{card}: counted frame (combined L{LEVELS}, shadows, u8) "
          f"in the root form {frame_ms:.3f} ms, image equal to the parent form's, visits "
          f"equal to its two passes' counts; launches {launches}; registers of the root "
          f"form's counting and flag forms: {regs}")


def schedule_forms(dev, words, origin, dirs, table, st) -> dict:
    """Phase 9d's K1 forms on the image rows ``TERRAIN_ROWS`` as a flat
    batch (the plain version of the whole frame takes seconds a form): the
    start forms (K11's block-8 starts) in both restart forms without a
    table, with a warp table and with the combined table, and in brick mode
    on the terrain (its own K11 starts); the seed forms (``warp_in_body=
    False``: a table read for first descents only), both tables and both
    restart forms, the primary pass and the shadow mode. Each equal to its
    plain version on every field (the shadow mode's mask) and, counting and
    flagging, on every visit slot (flags the counts' nonzero set). Returns
    {form: its entry}, which ``schedules_phase`` reports."""
    from octree_tracer_tpu_torch.render import bricks, tracer

    r0, r1 = TERRAIN_ROWS
    band = slice(r0 * W, r1 * W)
    b_dirs = dirs[r0:r1].reshape(-1, 3).contiguous()
    b_orig = origin.expand(b_dirs.shape[0], 3)
    b_st = tuple(x[band].contiguous() for x in st)
    if "terrain_bricks" not in K1:  # phase 9c's
        K1["terrain_bricks"] = bricks.build_bricks(K1["terrain"][0])
    dec, br = K1["terrain_bricks"]
    t_words, t_origin, t_dirs = K1["terrain"]
    t_st, _ = tracer.beam_start(dec, t_origin, t_dirs, 8)
    t_b = t_dirs[r0:r1].reshape(-1, 3).contiguous()
    tables = {"none": None, "warp": tracer.build_warp_table(words, LEVELS), "combined": table}
    cases = {}
    for restart in (True, False):
        form = "parent" if restart else "root"
        for name, t in tables.items():
            cases[f"start {form} {name} table"] = (
                words, b_orig, b_dirs, dict(start=b_st, warp_table=t))
            if t is not None:
                cases[f"seed {form} {name} table"] = (
                    words, b_orig, b_dirs, dict(warp_table=t, warp_in_body=False))
        cases[f"start {form} bricks terrain"] = (
            dec, t_origin.expand(t_b.shape[0], 3), t_b,
            dict(start=tuple(x[band].contiguous() for x in t_st), bricks=br, brick_k=4))
    out = {}
    for what, (w_, o_, d_, kw) in cases.items():
        restart = " parent " in what
        n_words = w_.shape[0]
        v_p = torch.zeros(n_words, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        r_p = tracer.trace_plain(w_, o_, d_, visits=v_p, parent_restart=restart, **kw)
        plain_s = time.perf_counter() - t0
        errs = []
        for flags, want in ((False, v_p), (True, (v_p > 0).int())):
            v_k = torch.zeros_like(v_p)
            r_k = tracer.trace(w_, o_, d_, visits=v_k, visit_flags=flags,
                               parent_restart=restart, **kw)
            differ = [f for f, a, c in zip(r_k._fields, r_k, r_p) if not torch.equal(a, c)]
            check(not differ and torch.equal(v_k, want),
                  f"K1 {what} (flags {flags}): {differ} differ from plain, visits on "
                  f"{int((v_k != want).sum())} slots")
            errs.append(max_abs_err(list(zip(r_k, r_p)) + [(v_k, want)]))
        entry = dict(max_abs_err=max(errs), visits_exact=True, marks=int(v_p.sum()),
                     hits=int(r_p.hit.sum()), plain_s=plain_s)
        if what.startswith("seed"):
            # The shadow mode from the same table, counted (every hit's ray,
            # as a counting frame traces them; the culled mask is the
            # frame's, held below).
            v_p = torch.zeros(n_words, dtype=torch.int32, device=dev)
            so, sd, active = tracer.shadow_rays(r_p, cull=False)
            sh_p = tracer.trace_plain(w_, so, sd, active, visits=v_p, parent_restart=restart,
                                      **kw).hit
            v_k = torch.zeros_like(v_p)
            sh_k = tracer.trace_shadow(w_, r_p, cull=False, visits=v_k, parent_restart=restart,
                                       image_width=0, **kw)
            check(torch.equal(sh_k, sh_p) and torch.equal(v_k, v_p),
                  f"K1 {what} shadow mode: hits differ on {int((sh_k != sh_p).sum())} rays, "
                  f"visits on {int((v_k != v_p).sum())} slots")
            entry.update(shadow_hits=int(sh_p.sum()), shadow_marks=int(v_p.sum()))
        out[what] = entry
    return out


def schedules_phase(dev, report, words, origins, dirs, table, res_k, ci, card) -> None:
    """Phase 9d: the JAX frame's schedules and ray orders on the deep10
    1080p frame. A block must divide both sides: 16 does not divide 1080,
    and JAX's frame then skips the beam pre-pass (so does the port's), so
    the phase takes blocks 8 (JAX's beam tile) and 24, and 6 for K3 (four
    consecutive outputs across a tile's rows). K3's block form equal to its
    plain version and to the pixel form after ``_pixel_to_block``; K11
    (``beam_start``) equal to its plain version at blocks 8 and 24 (and the
    ``>=`` descent) and on the terrain; K1's start forms (K11's starts,
    block 8) equal to plain on every field and visit slot, without a table
    and with the combined table, and to the no-start pass on every hit
    field; every start and seed form on a band of rows (``schedule_forms``);
    JAX's flagship call (beam mode, rays from K3's block form,
    ``pre_permuted``, ``raw_result``, u8, the combined table) equal to the
    pixel-order frame after ``_block_to_pixel``; K4's block-order writes
    (row-major and Morton tiles) equal to its pixel-order frame; the staged
    frame without a table with and without ``beams=8`` equal to the
    pixel-order one, and ``beams=16`` launching no K11; the staged frame
    with ``warp_in_body=False`` and ``trace_staged`` with the combined
    table (the seed forms) equal to plain on the band. These paths counted,
    the frames timed in turn, K1's trips with and without the starts
    (``loop_trips``)."""
    from octree_tracer_tpu_torch import kernels, scenes, state
    from octree_tracer_tpu_torch.probes.gather_probe import cuda_ms as device_ms
    from octree_tracer_tpu_torch.probes.gather_probe import time_in_turn
    from octree_tracer_tpu_torch.render import camera, tracer

    n, n_words = W * H, words.shape[0]
    origin = origins[0]
    flat = dirs.reshape(n, 3)
    ci_t = torch.from_numpy(ci).to(dev)
    t_phase = time.perf_counter()

    # K3's block form.
    for b in (8, 6):
        o_b, d_b = camera.generate_rays_device(ci, W, H, dev, block_major=b)
        o_p, d_p = camera.generate_rays_device_plain(ci_t, W, H, block_major=b)
        check(tuple(d_b.shape) == (n, 3) and torch.equal(d_b, d_p) and torch.equal(o_b, o_p),
              f"raygen block {b}: kernel differs from plain by "
              f"{float((d_b - d_p).abs().max())}")
        check(torch.equal(d_b, tracer._pixel_to_block(flat, H, W, b)) and torch.equal(o_b, origin),
              f"raygen block {b}: not the pixel form in block order")
    k3 = time_in_turn({
        "pixel": lambda: camera.generate_rays_device(ci, W, H, dev),
        "block": lambda: camera.generate_rays_device(ci, W, H, dev, block_major=8)}, 5, 50)
    report["raygen_block_major"].update(
        max_abs_err=max_abs_err([(d_b, d_p)]), alone_ms=k3["block"]["median"],
        alone_range=k3["block"]["range"], pixel_alone_ms=k3["pixel"]["median"],
        ms=cuda_ms(lambda: camera.generate_rays_device(ci, W, H, dev, block_major=8), 50, 5),
        plain_ms=cuda_ms(lambda: camera.generate_rays_device_plain(ci_t, W, H, 8), 5),
        library_ms=None, **bound(n * 12 + 12 + 64))
    r3 = report["raygen_block_major"]
    phase("9d K3 block", f"{card}: block 8 and 6 equal to plain and to the pixel form "
          f"after _pixel_to_block; alone in turn block 8 {r3['alone_ms']:.5f} ms "
          f"{r3['alone_range']}, pixel {r3['pixel_alone_ms']:.5f}; wrapper {r3['ms']:.5f}; "
          f"bound {r3['bound_ms']:.5f}; plain {r3['plain_ms']:.3f} ms")

    # K11 against its plain version.
    if "terrain" not in K1:
        tw = state.u32_to_device(scenes.terrain(TERRAIN_DEPTH, dev), dev)
        pos, look, fov = scenes.TERRAIN_CAMERA
        to, td = camera.generate_rays_device(camera.camera_matrices(pos, look, fov, W, H)[1],
                                             W, H, dev)
        K1["terrain"] = (tw, to, td)
    cases = {"deep10 b8": (words, origin, dirs, 8, True),
             "deep10 b24": (words, origin, dirs, 24, True),
             "deep10 b8 >=": (words, origin, dirs, 8, False),
             "terrain b8": (*K1["terrain"], 8, True)}
    errs, started = [], {}
    for what, (w_, o_, d_, b, strict) in cases.items():
        got = tracer.beam_start(w_, o_, d_, b, strict_descent=strict)
        want = tracer.beam_start_plain(w_, o_, d_, b, strict_descent=strict)
        pairs = list(zip(got[0], want[0])) + [(got[1], want[1])]
        check(all(torch.equal(a, c) for a, c in pairs), f"beam_start {what} differs from plain")
        errs.append(max_abs_err(pairs))
        started[what] = (float((got[0][2] > 0).float().mean()),
                         float(got[0][2].float().mean()),
                         int((got[1] < w_.shape[0]).sum()))
    st, visit_idx = tracer.beam_start(words, origin, dirs, 8)
    tiles = visit_idx.shape[0]
    rows = int(torch.unique(visit_idx[visit_idx < n_words] >> 3).numel())
    report["beam_start"].update(
        max_abs_err=max(errs), alone_ms=device_ms(lambda: tracer.beam_start(
            words, origin, dirs, 8), 50),
        ms=cuda_ms(lambda: tracer.beam_start(words, origin, dirs, 8), 50, 5),
        plain_ms=cuda_ms(lambda: tracer.beam_start_plain(words, origin, dirs, 8), 3),
        library_ms=None, tiles=tiles, rows=rows,
        **bound(tracer.beam_start_bytes(n, tiles, visit_idx.shape[1], rows)))
    rb = report["beam_start"]
    phase("9d K11", f"{card}: equal to plain on {sorted(cases)} (rays with a start, mean "
          f"start depth, tile marks: {started}); deep10 block 8: {tiles} tiles, "
          f"{rows} pool rows; alone {rb['alone_ms']:.5f} ms, wrapper {rb['ms']:.5f}, bound "
          f"{rb['bound_ms']:.5f} ({rb['bound_by']}), plain {rb['plain_ms']:.3f} ms")

    # K1's start forms: equal to plain, and to the pass without starts.
    start_entry = {}
    for what, t in (("none", None), ("combined", table)):
        base = res_k if t is not None else tracer.trace(words, origins, dirs)
        v_k = torch.zeros(n_words, dtype=torch.int32, device=dev)
        v_p = torch.zeros_like(v_k)
        r_k = tracer.trace(words, origins, dirs, start=st, warp_table=t, visits=v_k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_p = tracer.trace_plain(words, origins, flat, start=st, warp_table=t, visits=v_p)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        differ = [f for f, a, c in zip(r_k._fields, r_k, r_p) if not torch.equal(a, c)]
        check(not differ and torch.equal(v_k, v_p), f"start, {what} table: {differ} differ "
              f"from plain, visits on {int((v_k != v_p).sum())} slots")
        # Without a table a start changes no field. With the combined table
        # a ray's first descent starts at its start, not at its table cell,
        # and its first step skips nothing (as in JAX), so a miss may leave
        # the cube from another empty leaf (``depth``) after other steps
        # (``steps``); the hit fields stay, but for knife-edge rays.
        fields = ("hit", "forced", "index", "hit_pos", "normal", "word")
        agree = (r_k.depth == base.depth) | ~base.hit
        for f in fields:
            a, c = getattr(r_k, f), getattr(base, f)
            agree &= (a == c).reshape(n, -1).all(dim=1)
        moved = int((~agree).sum())
        if t is None:
            check(moved == 0 and torch.equal(r_k.steps, base.steps)
                  and torch.equal(r_k.depth, base.depth),
                  f"start, no table: {moved} rays differ from the pass without starts")
        check(moved <= 0.005 * n, f"start, {what} table: {moved} rays differ from the pass "
              f"without starts")
        trips = {k: loop_trips(lambda c, kw=kw: tracer.trace(words, origins, dirs, warp_table=t,
                                                             max_iters=c, **kw), base)[0]
                 for k, kw in (("start", {"start": st}), ("no_start", {}))}
        times = time_in_turn({
            "start": lambda: tracer.trace(words, origins, dirs, start=st, warp_table=t),
            "no_start": lambda: tracer.trace(words, origins, dirs, warp_table=t)}, 5, 10)
        start_entry[what] = dict(
            max_abs_err=max_abs_err(zip(r_k, r_p)), visits_exact=True, moved_rays=moved,
            trips=trips["start"], no_start_trips=trips["no_start"],
            alone_ms=times["start"]["median"], alone_range=times["start"]["range"],
            no_start_alone_ms=times["no_start"]["median"], plain_ms=plain_ms,
            # The primary pass's bytes and each ray's 20-byte start.
            **bound(tracer.k1_bytes(tracer.touched_rows(v_k), n) + 20 * n))
        e = start_entry[what]
        phase("9d K1 start", f"{card}: deep{DEPTH} {W}x{H}, {what} table, K11's block-8 "
              f"starts: every field and all {n_words} visit slots equal to plain; {moved} "
              f"rays differ from the pass without starts on a hit field; loop trips "
              f"{e['trips']} with starts, {e['no_start_trips']} without; alone in turn "
              f"{e['alone_ms']:.4f} ms {e['alone_range']} with, {e['no_start_alone_ms']:.4f} "
              f"without; bound {e['bound_ms']:.4f} ms; plain counts {plain_ms:.0f} ms")

    forms = schedule_forms(dev, words, origin, dirs, table, st)
    phase("9d K1 forms", f"{card}: rows {TERRAIN_ROWS} of deep{DEPTH} {W}x{H} (and of the "
          f"terrain with bricks): every start and seed form equal to plain on every field, "
          f"shadow bit and visit slot, counts and flags: "
          + "; ".join(f"{k} {v['hits']} hits {v['marks']} marks (plain {v['plain_s']:.1f} s)"
                      for k, v in forms.items()))

    # JAX's flagship call: rays in block order from K3, beam mode,
    # pre_permuted, raw_result, u8, the combined table; counted.
    sun = torch.tensor(tracer.DEFAULT_SUN)

    def flagship():
        o8, d8 = camera.generate_rays_device(ci, W, H, dev, block_major=8)
        return tracer.render_frame(words, o8, d8.reshape(H, W, 3), sun, shadows=True,
                                   mode="beam", raw_result=True, u8_image=True,
                                   pre_permuted=True, warp_table=table)

    torch.cuda.synchronize()
    kernels.reset_launches()
    img_f, res_f, _ = flagship()
    torch.cuda.synchronize()
    flag_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(flag_launches == {"raygen": 1, "trace": 2, "shade_encode": 1},
          f"the flagship call's launches: {flag_launches}")
    img_px, res_px, _ = tracer.render_frame(words, origin, dirs, warp_table=table,
                                            u8_image=True)
    check(torch.equal(img_f, img_px), "the flagship image differs from the pixel-order frame")
    back = [tracer._block_to_pixel(f, H, W, 8) for f in res_f]
    differ = [f for f, a, c in zip(res_px._fields, back, res_px) if not torch.equal(a, c)]
    check(not differ, f"the flagship result after _block_to_pixel differs on {differ}")
    # K4's block-order writes, row-major and Morton tiles: the pixel-order
    # frame's image, u8 and f32, from the result in block order.
    sh_px = tracer.trace_shadow(words, res_px, warp_table=table, image_width=W)
    for morton in (False, True):
        order = (H, W, 8, morton)
        r_bm = tracer.TraceResult(*(tracer._pixel_to_block(f, *order) for f in res_px))
        sh_bm = tracer._pixel_to_block(sh_px, *order)
        for u8 in (True, False):
            check(torch.equal(tracer.shade(r_bm, sh_bm, u8=u8, block_order=order),
                              tracer.shade(res_px, sh_px, u8=u8)),
                  f"K4 in block order (Morton {morton}, u8 {u8}) differs from pixel order")
    r_bm = tracer.TraceResult(*(tracer._pixel_to_block(f, H, W, 8) for f in res_px))
    sh_bm = tracer._pixel_to_block(sh_px, H, W, 8)
    k4 = time_in_turn({
        "pixel": lambda: tracer.shade(res_px, sh_px, u8=True),
        "block": lambda: tracer.shade(r_bm, sh_bm, u8=True, block_order=(H, W, 8, False))},
        5, 20)

    # The staged frame without a table, with and without beams=8; counted.
    # beams=16 does not divide 1080: no pre-pass, as in JAX.
    img_s, res_s, _ = tracer.render_frame(words, origin, dirs, u8_image=True, mode="staged")
    torch.cuda.synchronize()
    kernels.reset_launches()
    tracer.render_frame(words, origin, dirs, u8_image=True, mode="staged", beams=16)
    torch.cuda.synchronize()
    check(not kernels.LAUNCHES["beam_start"], "beams=16 at 1080 rows ran the pre-pass")
    kernels.reset_launches()
    img_b, res_b, _ = tracer.render_frame(words, origin, dirs, u8_image=True, mode="staged",
                                          beams=8)
    torch.cuda.synchronize()
    beam_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(beam_launches == {"beam_start": 1, "trace": 2, "shade_encode": 1},
          f"the beams=8 frame's launches: {beam_launches}")
    img_0, res_0, _ = tracer.render_frame(words, origin, dirs, u8_image=True)
    check(torch.equal(img_s, img_0) and torch.equal(img_b, img_0),
          "the staged frames differ from the pixel-order frame without a table")
    differ = [f for f, a, b, c in zip(res_0._fields, res_s, res_b, res_0)
              if not (torch.equal(a, c) and torch.equal(b, c))]
    check(not differ, f"the staged frames' results differ on {differ}")
    # The table for first descents only (the seed forms): JAX's staged
    # frame with warp_in_body=False and trace_staged with its default,
    # counted; rows TERRAIN_ROWS held to the plain versions.
    kernels.reset_launches()
    img_w, res_w, _ = tracer.render_frame(words, origin, dirs, warp_table=table, u8_image=True,
                                          mode="staged", warp_in_body=False)
    torch.cuda.synchronize()
    seed_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(seed_launches == {"trace": 2, "shade_encode": 1},
          f"the warp_in_body=False frame's launches: {seed_launches}")
    kernels.reset_launches()
    res_t, v_t = tracer.trace_staged(words, origins, flat, warp_table=table, with_visits=True)
    torch.cuda.synchronize()
    staged_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(staged_launches == {"trace": 1}, f"trace_staged's launches: {staged_launches}")
    r0, r1 = TERRAIN_ROWS
    b_dirs = dirs[r0:r1].reshape(-1, 3).contiguous()
    b_orig = origin.expand(b_dirs.shape[0], 3)
    r_p = tracer.trace_plain(words, b_orig, b_dirs, warp_table=table, warp_in_body=False)
    so, sd, active = tracer.shadow_rays(r_p)
    sh_p = tracer.trace_plain(words, so, sd, active, warp_table=table, warp_in_body=False).hit
    img_p = tracer.encode_u8_plain(tracer.shade_plain(r_p, sh_p))
    band = slice(r0 * W, r1 * W)
    differ = [f for f, a, b, c in zip(r_p._fields, res_w, res_t, tracer._record_fields(r_p, False))
              if not (torch.equal(a[band], c) and torch.equal(b[band], c))]
    check(not differ and torch.equal(img_w[r0:r1].reshape(-1, 3), img_p),
          f"the warp_in_body=False frame or trace_staged differ from plain on rows "
          f"{TERRAIN_ROWS}: {differ}, image on "
          f"{int((img_w[r0:r1].reshape(-1, 3) != img_p).any(dim=1).sum())} pixels")
    v_k = torch.zeros_like(v_t)
    tracer.trace(words, origins, flat, warp_table=table, warp_in_body=False, visits=v_k)
    check(torch.equal(v_t, v_k), "trace_staged's visits differ from trace's")
    d8 = camera.generate_rays_device(ci, W, H, dev, block_major=8)[1].reshape(H, W, 3)
    frames = time_in_turn({
        "pixel": lambda: tracer.render_frame(words, origin, dirs, warp_table=table,
                                             u8_image=True),
        "flagship": lambda: tracer.render_frame(
            words, origin, d8, sun, mode="beam", raw_result=True, u8_image=True,
            pre_permuted=True, warp_table=table),
        "no_table": lambda: tracer.render_frame(words, origin, dirs, u8_image=True,
                                                mode="staged"),
        "no_table_beams8": lambda: tracer.render_frame(words, origin, dirs, u8_image=True,
                                                       mode="staged", beams=8),
        "table_first_descents": lambda: tracer.render_frame(
            words, origin, dirs, warp_table=table, u8_image=True, mode="staged",
            warp_in_body=False)}, 5, 10)
    report["raygen_block_major"]["launches"] = flag_launches.get("raygen", 0)
    report["beam_start"]["launches"] = beam_launches.get("beam_start", 0)
    report["trace"]["start"] = dict(start_entry, frame_launches=beam_launches.get("trace", 0),
                                    forms={k: v for k, v in forms.items()
                                           if k.startswith("start")})
    report["trace"]["seed"] = dict(
        forms={k: v for k, v in forms.items() if k.startswith("seed")},
        frame_launches=seed_launches.get("trace", 0),
        trace_staged_launches=staged_launches.get("trace", 0),
        frame_ms=frames["table_first_descents"]["median"])
    report["shade_encode"].update(
        block_order_launches=flag_launches.get("shade_encode", 0),
        block_order_alone_ms=k4["block"]["median"], pixel_order_alone_ms=k4["pixel"]["median"])
    report["trace"]["schedule_frames"] = {k: v["median"] for k, v in frames.items()}
    med = {k: f"{v['median']:.4f} {v['range']}" for k, v in frames.items()}
    phase("9d frames", f"{card}: deep{DEPTH} {W}x{H} shadows u8: JAX's flagship call "
          f"(beam, K3 block 8, pre_permuted, raw_result, combined L{LEVELS}) equal to the "
          f"pixel-order frame after _block_to_pixel, launches {flag_launches}; K4's "
          f"block-order writes equal, alone in turn u8 {k4['block']['median']:.5f} ms "
          f"(pixel order {k4['pixel']['median']:.5f}); staged without a table and with "
          f"beams=8 equal to the pixel-order frame, launches {beam_launches}; the combined "
          f"table for first descents only (staged frame, launches {seed_launches}; "
          f"trace_staged, {staged_launches}) equal to plain on rows {TERRAIN_ROWS}; alone in "
          f"turn, median ms [range]: {med}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def loop_trips(trace_capped, full) -> tuple[int, int]:
    """(total loop trips, a bound on the longest ray's) of the rays of
    ``full``, the uncapped result, counted with K1's own cap: a ray that
    resolves (hit, left the cube or forced) reports a depth of 1 or more,
    and one still active after ``max_iters`` trips reports 0, so a ray's
    trips are the caps T = 0, 1, ... under which it reports 0. The longest
    ray takes at most the returned bound and more than 16 fewer."""
    live = full.depth > 0
    total = torch.zeros((), dtype=torch.int64, device=full.depth.device)
    cap = 0
    while True:
        left = (trace_capped(cap).depth == 0) & live
        total += left.sum()
        if cap % 16 == 15 and not bool(left.any()):
            return int(total), cap
        cap += 1


def trip_latency_ns(dev) -> float:
    """K1's trip on L2-resident rows, in ns: one ray down
    ``scenes.chain_pool``'s cycle of 2^20 groups (32 MiB, inside the 50 MB
    L2; no row read twice within 2^20 trips), traced with max_iters 16384
    and 8192, each the kernel alone behind a spin; the difference over 8192
    trips. Each trip is one dependent row load and the trip's arithmetic."""
    from octree_tracer_tpu_torch import scenes, state
    from octree_tracer_tpu_torch.probes.gather_probe import cuda_ms as device_ms
    from octree_tracer_tpu_torch.render import tracer

    if "trip_ns" not in K1:
        chain = state.u32_to_device(scenes.chain_pool(1 << 20), dev)
        o = torch.tensor([[0.1, 0.2, 0.3]], device=dev)
        d = torch.tensor([[0.3, 0.5, 0.8]], device=dev)
        ms = {t: device_ms(lambda t=t: tracer.trace(chain, o, d, max_iters=t), 5)
              for t in (8192, 16384)}
        K1["trip_ns"] = (ms[16384] - ms[8192]) / 8192 * 1e6
    return K1["trip_ns"]


def latency_bound(trace_capped, full) -> dict:
    """The latency bound of a pass: the loop trips of its longest ray
    (``tracer.longest_trips`` over the rays ``full`` resolves) times K1's
    trip on L2-resident rows."""
    from octree_tracer_tpu_torch.render import tracer

    longest = tracer.longest_trips(trace_capped, full.depth > 0,
                                   tracer._max_iters(tracer.MAX_STEPS, None))
    return {"longest_trips": longest, "trip_ns": trip_latency_ns(full.depth.device),
            "latency_bound_ms": longest * trip_latency_ns(full.depth.device) * 1e-6}


def counters():
    """K1's counting library (``k1_counters.Counting``), its build waited
    for once."""
    from octree_tracer_tpu_torch.probes import k1_counters

    if "counters" not in K1:
        K1["counters"] = k1_counters.Counting(k1_counters.finish_build(*K1["counters_build"]))
    return K1["counters"]


def brick_trace_rows(dec, visits) -> tuple[int, int]:
    """(pool rows, brick rows) that a brick-mode trace read, from its visit
    counts ``visits`` on the decorated pool ``dec`` (a well-formed one). A
    brick root whose children row holds a mark was entered, by the main
    body or from an enclosing brick, and its brick row read: its sub-steps
    mark its children, a row the main body never reads. Every other marked
    row is a pool row that the main body read."""
    from octree_tracer_tpu_torch import state
    w = state.widen_u32(dec)
    marked = torch.nn.functional.pad(visits, (0, -visits.shape[0] % 8)).view(-1, 8)
    marked = (marked != 0).any(dim=1)
    slots = torch.nonzero(visits).flatten()
    roots = slots[(w[slots] & 1) == 1]
    entered = int(marked[((w[roots] >> 4) >> 3).clamp(max=marked.shape[0] - 1)].sum())
    return int(marked.sum()) - entered, entered


def brick_scenes(dev) -> str:
    """K1's brick forms against their plain version on small scenes on the
    card: random trees under random rays (origins outside the cube
    included) and a dense slab at max_steps=6 (forced caps, rays leaving
    the cube), both restart forms, counts; the malformed pools with bricks
    built from them, counts and flags and the shadow mode."""
    from octree_tracer_tpu_torch import scenes, state
    from octree_tracer_tpu_torch.core import CpuOctree
    from octree_tracer_tpu_torch.render import bricks, tracer

    def tree(depth, voxels, seed, side_depth=None):
        rng = np.random.default_rng(seed)
        t = CpuOctree(0)
        side = 1 << (side_depth or depth)
        for c in rng.integers(0, side, (voxels, 3)):
            t.put_in_voxel(c.astype(np.float32) / side * 2 - 1, int(rng.integers(1, 1 << 24)),
                           depth)
        return t.to_words()

    def rays(seed, n, span):
        rng = np.random.default_rng(seed)
        o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)

    def same(kw, words, o, d, what, flags=(False, True)):
        dec, br = bricks.build_bricks(words)
        v_p = torch.zeros(words.shape[0], dtype=torch.int32, device=dev)
        r_p = tracer.trace_plain(dec, o, d, bricks=br, visits=v_p, **kw)
        for f in flags:
            v_k = torch.zeros_like(v_p)
            r_k = tracer.trace(dec, o, d, bricks=br, visits=v_k, visit_flags=f, **kw)
            differ = [x for x, a, b in zip(r_k._fields, r_k, r_p) if not torch.equal(a, b)]
            check(not differ, f"brick trace: {differ} differ from plain on {what}")
            want = (v_p > 0).int() if f else v_p
            check(torch.equal(v_k, want), f"brick trace visits (flags {f}) differ from "
                  f"plain on {what}")
        sh_k, sh_p = torch.zeros_like(v_p), torch.zeros_like(v_p)
        kw = {k: v for k, v in kw.items() if k != "max_iters"}  # the shadow mode's default
        h_k = tracer.trace_shadow(dec, r_k, cull=False, bricks=br, visits=sh_k,
                                  image_width=0, **kw)
        h_p = tracer.trace_plain(dec, *tracer.shadow_rays(r_k, cull=False), bricks=br,
                                 visits=sh_p, **kw).hit
        check(torch.equal(h_k, h_p) and torch.equal(sh_k, sh_p),
              f"brick shadow mode differs from plain on {what}")
        return r_k

    out = []
    for depth, voxels, seed in ((3, 80, 24), (5, 400, 25), (6, 900, 26)):
        words = state.u32_to_device(tree(depth, voxels, seed), dev)
        o, d = rays(seed, 4096, 3.0)
        for restart in (True, False):
            for k in (1, 4):
                r = same(dict(parent_restart=restart, brick_k=k), words, o, d,
                         f"tree {depth}/{voxels}, restart {restart}, brick_k {k}")
        out.append(int(r.hit.sum()))
    words = state.u32_to_device(tree(4, 500, 3, side_depth=4), dev)
    o, d = rays(3, 4096, 1.0)
    r = same(dict(max_steps=6), words, o, d, "dense slab, max_steps 6")
    forced, left = int(r.forced.sum()), int((~r.hit).sum())
    check(forced > 0 and left > 0, f"slab: {forced} forced, {left} rays left the cube")
    mal = 0
    for name, pool in scenes.malformed_pools().items():
        words = state.u32_to_device(pool, dev)
        for cam in ((-0.35, 0.55, -0.6), (0.0, 0.3, -0.45), (0.4, 0.6, -2.2)):
            d = rays(7, 2048, 0.0)[1]
            o = torch.tensor(cam, dtype=torch.float32, device=dev).expand(2048, 3).contiguous()
            for restart in (True, False):
                r = same(dict(parent_restart=restart, max_iters=600), words, o, d,
                         f"{name} from {cam}, restart {restart}")
                mal += int(r.hit.sum())
    return (f"kernel equal to plain (every field, counts, flags, shadow hits and counts) on "
            f"random trees of 3/5/6 levels, 4096 random rays each, both restart forms, "
            f"brick_k 1 and 4 ({out} hits), a dense slab at max_steps 6 ({forced} forced, "
            f"{left} out of the cube) and the malformed pools from 3 points, both forms "
            f"({mal} hits)")


def terrain_bricks(dev, card) -> dict:
    """Phase 9c on the generated island terrain (``scenes.terrain(9)``, a
    512^3 chunk spanning the root cube, the scene bricks are for) from its
    grazing camera at 1920x1080: K1's brick forms (brick_k 4) equal to their
    plain version on the image rows ``TERRAIN_ROWS`` around the horizon
    (every field, the shadow mask and every visit slot, counts and flags,
    both restart forms; the plain version of the whole frame takes
    minutes), and to the no-table form on every field and the culled shadow
    mask over the whole frame; the primary pass and the shadow mode timed
    in turn against the no-table form and the combined table; loop trips,
    the warps' split, the rows read and the latency bounds."""
    from octree_tracer_tpu_torch import scenes, state
    from octree_tracer_tpu_torch.probes.gather_probe import time_in_turn
    from octree_tracer_tpu_torch.render import bricks, camera, skip, tracer

    t0 = time.perf_counter()
    words = state.u32_to_device(scenes.terrain(TERRAIN_DEPTH, dev), dev)
    gen_s = time.perf_counter() - t0
    n_words, n = words.shape[0], W * H
    pos, look, fov = scenes.TERRAIN_CAMERA
    origin, dirs = camera.generate_rays_device(camera.camera_matrices(pos, look, fov, W, H)[1],
                                               W, H, dev)
    K1["terrain"] = (words, origin, dirs)  # phase 9d's K11 case
    origins = origin.expand(n, 3)
    dec, br = bricks.build_bricks(words)
    K1["terrain_bricks"] = (dec, br)  # and its brick start forms
    table = skip.build_warp_skip_table(words, LEVELS)
    base = tracer.trace(words, origins, dirs)

    # The row block: kernel against plain, both restart forms.
    r0, r1 = TERRAIN_ROWS
    b_dirs = dirs[r0:r1].contiguous()
    b_orig = origin.expand(b_dirs.shape[0] * W, 3)
    errs, marks = [], {}
    for restart in (True, False):
        form = "parent" if restart else "root"
        kw = dict(bricks=br, brick_k=4, parent_restart=restart)
        v_p = torch.zeros(n_words, dtype=torch.int32, device=dev)
        r_p = tracer.trace_plain(dec, b_orig, b_dirs.reshape(-1, 3), visits=v_p, **kw)
        for flags, want in ((False, v_p), (True, (v_p > 0).int())):
            v_k = torch.zeros_like(v_p)
            r_k = tracer.trace(dec, b_orig, b_dirs, visits=v_k, visit_flags=flags, **kw)
            differ = [f for f, a, b in zip(r_k._fields, r_k, r_p) if not torch.equal(a, b)]
            check(not differ, f"terrain bricks, {form} form: {differ} differ from plain")
            check(torch.equal(v_k, want), f"terrain bricks, {form} form, flags {flags}: "
                  f"visits differ from plain on {int((v_k != want).sum())} slots")
            errs.append(max_abs_err(zip(r_k, r_p)))
        sh_k, sh_p = torch.zeros_like(v_p), torch.zeros_like(v_p)
        hit_k = tracer.trace_shadow(dec, r_k, cull=False, visits=sh_k, image_width=W, **kw)
        hit_p = tracer.trace_plain(dec, *tracer.shadow_rays(r_k, cull=False), visits=sh_p,
                                   **kw).hit
        check(torch.equal(hit_k, hit_p) and torch.equal(sh_k, sh_p),
              f"terrain bricks, {form} form: the shadow mode differs from plain")
        marks[form] = int(v_p.sum())

    # The whole frame against the no-table form, and timed in turn.
    res_b = tracer.trace(dec, origins, dirs, bricks=br)
    check(all(torch.equal(a, b) for a, b in zip(res_b, base)),
          "terrain bricks: a field differs from the no-table form")
    check(torch.equal(tracer.trace_shadow(dec, res_b, bricks=br, image_width=W),
                      tracer.trace_shadow(words, base, image_width=W)),
          "terrain bricks: the culled shadow mask differs from the no-table form's")
    res_c = tracer.trace(words, origins, dirs, warp_table=table)
    prim = time_in_turn({
        "bricks": lambda: tracer.trace(dec, origins, dirs, bricks=br),
        "bricks_k1": lambda: tracer.trace(dec, origins, dirs, bricks=br, brick_k=1),
        "bricks_k8": lambda: tracer.trace(dec, origins, dirs, bricks=br, brick_k=8),
        "no_table": lambda: tracer.trace(words, origins, dirs),
        "combined": lambda: tracer.trace(words, origins, dirs, warp_table=table)}, 5, 10)
    shadow = time_in_turn({
        "bricks": lambda: tracer.trace_shadow(dec, res_b, bricks=br, image_width=W),
        "no_table": lambda: tracer.trace_shadow(words, base, image_width=W),
        "combined": lambda: tracer.trace_shadow(words, res_c, warp_table=table,
                                                image_width=W)}, 5, 10)
    trips = {
        "bricks": loop_trips(lambda c: tracer.trace(dec, origins, dirs, bricks=br,
                                                    max_iters=c), res_b),
        "no_table": loop_trips(lambda c: tracer.trace(words, origins, dirs, max_iters=c), base)}
    with counters() as c:
        tracer.trace(dec, origins, dirs, bricks=br)
        split = c.read()
    v_b = torch.zeros(n_words, dtype=torch.int32, device=dev)
    tracer.trace(dec, origins, dirs, bricks=br, visits=v_b)
    pool_rows, brick_rows = brick_trace_rows(dec, v_b)
    v_n = torch.zeros_like(v_b)
    tracer.trace(words, origins, dirs, visits=v_n)
    lat = latency_bound(lambda c: tracer.trace(dec, origins, dirs, bricks=br, max_iters=c),
                        res_b)
    nt_lat = latency_bound(lambda c: tracer.trace(words, origins, dirs, max_iters=c), base)
    out = dict(
        words=n_words, build_s=gen_s, hits=int(base.hit.sum()), forced=int(base.forced.sum()),
        brick_roots=int((dec & 1).sum()), rows_checked=[r0, r1], max_abs_err=max(errs),
        block_marks=marks, primary_ms={k: v["median"] for k, v in prim.items()},
        primary_range={k: v["range"] for k, v in prim.items()},
        shadow_ms={k: v["median"] for k, v in shadow.items()},
        loop_trips={k: {"total": v[0], "longest_at_most": v[1]} for k, v in trips.items()},
        split=split, split_share=split["split_warp_trips"] / max(split["warp_trips"], 1),
        pool_rows=pool_rows, brick_rows=brick_rows, no_table_rows=tracer.touched_rows(v_n),
        bound_ms=bound(tracer.k1_bytes(pool_rows + brick_rows, n))["bound_ms"],
        no_table_bound_ms=bound(tracer.k1_bytes(tracer.touched_rows(v_n), n))["bound_ms"],
        no_table_latency_bound_ms=nt_lat["latency_bound_ms"], **lat)
    phase("9c K1 terrain", f"{card}: terrain chunk_depth {TERRAIN_DEPTH} ({n_words} words, "
          f"{out['brick_roots']} brick roots, built in {gen_s:.1f} s) {W}x{H} from the grazing "
          f"camera: rows {r0}-{r1} equal to plain (every field, the shadow mask, every slot, "
          f"counts and flags, both restart forms; marks {marks}); the whole frame equal to "
          f"the no-table form ({out['hits']} hits, {out['forced']} forced); in turn, median "
          f"ms: primary {out['primary_ms']}, shadow mode {out['shadow_ms']}; loop trips "
          f"{out['loop_trips']}; warp-trips {split['warp_trips']}, {out['split_share']:.4f} "
          f"split, lane-trips brick {split['brick_lane_trips']} / descent "
          f"{split['descent_lane_trips']}; rows read {pool_rows} pool + {brick_rows} brick "
          f"(no table {out['no_table_rows']}); bound {out['bound_ms']:.4f} ms (no table "
          f"{out['no_table_bound_ms']:.4f}), latency {out['latency_bound_ms']:.4f} ms "
          f"({out['longest_trips']} trips; no table {out['no_table_latency_bound_ms']:.4f})")
    return out


def bricks_pages_phase(dev, report, words, words_np, origins, dirs, table, res_k, ci,
                       card) -> None:
    """Phase 9c: brick maps and paged pools on deep10 at 1080p. K10 equal to
    its plain version and to ``build_bricks_np`` on deep10's pool and the
    malformed pools, timed; K1's brick forms (no table) equal to their plain
    version on every field, the shadow mask and every visit slot, in both
    restart forms (counts and flags) at brick_k 4 and the parent form's
    primary at brick_k 1, and to the no-table form without bricks on every
    field; small scenes on the card (``brick_scenes``); the primary pass,
    the shadow mode and the shadowed u8 frame timed in turn against the
    no-table form and the combined table; then the slice's path counted
    (build_bricks, raygen, the frame with bricks), and the paged frame
    (``build_pages``, ``render_frame(paged=...)``) equal to the unpaged
    one after the remap, K1 over the relayout timed against the original
    pool."""
    from octree_tracer_tpu_torch import kernels, scenes, state
    from octree_tracer_tpu_torch.probes.gather_probe import cuda_ms as device_ms
    from octree_tracer_tpu_torch.probes.gather_probe import time_in_turn
    from octree_tracer_tpu_torch.render import bricks, camera, paging, tracer

    n_words, n = words.shape[0], W * H
    flat = dirs.reshape(-1, 3)
    origin = origins[0]

    # K10, exact against its plain version and the host NumPy version.
    dec, br = bricks.build_bricks(words)
    dec_p, br_p = bricks.build_bricks_plain(words)
    check(torch.equal(dec, dec_p) and torch.equal(br, br_p),
          "build_bricks kernel differs from its plain version on deep10")
    k10_err = max_abs_err(((dec, dec_p), (br, br_p)))
    t0 = time.perf_counter()
    dec_np, br_np = bricks.build_bricks_np(words_np)
    np_s = time.perf_counter() - t0
    check(np.array_equal(state.to_numpy_u32(dec), dec_np)
          and np.array_equal(state.to_numpy_u32(br), br_np),
          "build_bricks kernel differs from build_bricks_np on deep10")
    del dec_p, br_p, br_np
    for name, pool in scenes.malformed_pools().items():
        w = state.u32_to_device(pool, dev)
        got, plain, host = bricks.build_bricks(w), bricks.build_bricks_plain(w), \
            bricks.build_bricks_np(pool)
        check(all(torch.equal(a, b) for a, b in zip(got, plain))
              and all(np.array_equal(state.to_numpy_u32(a), b) for a, b in zip(got, host)),
              f"build_bricks kernel differs from plain or host on {name}")
    k10 = bricks.k10_bytes(words)
    roots = int((dec & 1).sum())
    report["brick_rows"].update(
        max_abs_err=k10_err, ms=cuda_ms(lambda: bricks.build_bricks(words), 20),
        alone_ms=device_ms(lambda: bricks.build_bricks(words), 20),
        plain_ms=cuda_ms(lambda: bricks.build_bricks_plain(words), 2), host_np_s=np_s,
        library_ms=None, brick_roots=roots, k10_bytes=k10, **bound(k10))
    r = report["brick_rows"]
    phase("9c K10 bricks", f"{card}: deep{DEPTH} pool ({n_words} words): decorated pool and "
          f"brick table equal to build_bricks_plain and build_bricks_np, and on "
          f"{sorted(scenes.malformed_pools())}; {roots} brick roots, table "
          f"{br.numel() * 4 / 1e6:.1f} MB; kernel alone {r['alone_ms']:.4f} ms, wrapper "
          f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({k10} bytes), plain "
          f"{r['plain_ms']:.1f} ms, build_bricks_np {np_s:.2f} s")

    # K1's brick forms on the frame's primaries and shadow rays, no table.
    base = tracer.trace(words, origins, dirs)
    entry, errs, exact = {}, [], []
    for restart in (True, False):
        form = "parent" if restart else "root"
        kw = dict(bricks=br, brick_k=4, parent_restart=restart)
        v_p = torch.zeros(n_words, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_p = tracer.trace_plain(dec, origins, flat, visits=v_p, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for flags, want in ((False, v_p), (True, (v_p > 0).int())):
            v_k = torch.zeros_like(v_p)
            r_k = tracer.trace(dec, origins, dirs, visits=v_k, visit_flags=flags, **kw)
            differ = [f for f, a, b in zip(r_k._fields, r_k, r_p) if not torch.equal(a, b)]
            check(not differ, f"bricks, {form} form: {differ} differ from plain")
            check(torch.equal(v_k, want), f"bricks, {form} form, flags {flags}: visits "
                  f"differ from plain on {int((v_k != want).sum())} slots")
            errs.append(max_abs_err(zip(r_k, r_p)))
            exact.append(torch.equal(v_k, want))
            differ = [f for f, a, b in zip(r_k._fields, r_k, base) if not torch.equal(a, b)]
            check(not differ, f"bricks, {form} form: {differ} differ from the no-table form")
        sh_k, sh_p = torch.zeros_like(v_p), torch.zeros_like(v_p)
        hit_k = tracer.trace_shadow(dec, r_k, cull=False, visits=sh_k, image_width=W, **kw)
        hit_p = tracer.trace_plain(dec, *tracer.shadow_rays(r_k, cull=False), visits=sh_p,
                                   **kw).hit
        check(torch.equal(hit_k, hit_p) and torch.equal(sh_k, sh_p),
              f"bricks, {form} form: the shadow mode differs from plain")
        errs.append(max_abs_err([(hit_k, hit_p)]))
        exact.append(torch.equal(sh_k, sh_p))
        pool_rows, brick_rows = brick_trace_rows(dec, v_p)
        culled = tracer.trace_shadow(dec, r_k, image_width=W, **kw)
        check(torch.equal(culled, tracer.trace_shadow(words, base, image_width=W)),
              f"bricks, {form} form: the culled shadow mask differs from the no-table form's")
        entry[form] = dict(marks=int(v_p.sum()), shadow_marks=int(sh_k.sum()),
                           plain_ms=plain_s * 1e3, pool_rows=pool_rows,
                           brick_rows=brick_rows)
    r1 = tracer.trace(dec, origins, dirs, bricks=br, brick_k=1)
    r1_p = tracer.trace_plain(dec, origins, flat, bricks=br, brick_k=1)
    check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(r1, r1_p, base)),
          "bricks at brick_k 1: the primary pass differs from plain or the no-table form")
    errs.append(max_abs_err(zip(r1, r1_p)))
    e = entry["parent"]
    phase("9c K1 bricks", f"{card}: deep{DEPTH} {W}x{H}, no table, brick_k 4: every field, "
          f"the shadow mask and all {n_words} visit slots equal to plain in both restart "
          f"forms (counts and flags), every field and the culled shadow mask equal to the "
          f"no-table form; brick_k 1 primary equal to plain and to the no-table form; parent "
          f"form {e['marks']} marks ({e['shadow_marks']} shadow), {e['pool_rows']} pool rows "
          f"and {e['brick_rows']} brick rows read; root form {entry['root']['marks']} marks; "
          f"plain {e['plain_ms']:.0f} / {entry['root']['plain_ms']:.0f} ms")
    phase("9c K1 bricks", f"{card}: {brick_scenes(dev)}")

    # Times in turn: bricks against the no-table form and the combined table.
    nt_v = torch.zeros(n_words, dtype=torch.int32, device=dev)
    tracer.trace(words, origins, dirs, visits=nt_v)
    nt_rows = tracer.touched_rows(nt_v)
    res_b = tracer.trace(dec, origins, dirs, bricks=br)
    prim = time_in_turn({
        "bricks": lambda: tracer.trace(dec, origins, dirs, bricks=br),
        "bricks_k1": lambda: tracer.trace(dec, origins, dirs, bricks=br, brick_k=1),
        "bricks_k8": lambda: tracer.trace(dec, origins, dirs, bricks=br, brick_k=8),
        "no_table": lambda: tracer.trace(words, origins, dirs),
        "combined": lambda: tracer.trace(words, origins, dirs, warp_table=table)}, 5, 10)
    shadow = time_in_turn({
        "bricks": lambda: tracer.trace_shadow(dec, res_b, bricks=br, image_width=W),
        "no_table": lambda: tracer.trace_shadow(words, base, image_width=W),
        "combined": lambda: tracer.trace_shadow(words, res_k, warp_table=table,
                                                image_width=W)}, 5, 10)
    frames = time_in_turn({
        "bricks": lambda: tracer.render_frame(dec, origin, dirs, bricks=br, u8_image=True),
        "no_table": lambda: tracer.render_frame(words, origin, dirs, u8_image=True),
        "combined": lambda: tracer.render_frame(words, origin, dirs, warp_table=table,
                                                u8_image=True)}, 5, 5)
    med = {k: {f: t[f]["median"] for f in t} for k, t in
           (("primary", prim), ("shadow", shadow), ("frame", frames))}
    # Loop trips a ray, by the kernel's own cap (its visit counts hold the
    # brick forms' sub-steps too).
    trips = {
        "bricks": loop_trips(lambda c: tracer.trace(dec, origins, dirs, bricks=br,
                                                    max_iters=c), res_b),
        "bricks_k1": loop_trips(lambda c: tracer.trace(dec, origins, dirs, bricks=br,
                                                       brick_k=1, max_iters=c), res_b),
        "no_table": loop_trips(lambda c: tracer.trace(words, origins, dirs, max_iters=c),
                               base),
        "combined": loop_trips(lambda c: tracer.trace(words, origins, dirs, warp_table=table,
                                                      max_iters=c), res_k)}

    # The warps' split between brick trips and descents and each mode's
    # lane-trips (the instrumented copy), and the latency bounds.
    with counters() as c:
        tracer.trace(dec, origins, dirs, bricks=br)
        split = c.read()
    lat = latency_bound(lambda cap: tracer.trace(dec, origins, dirs, bricks=br, max_iters=cap),
                        res_b)
    nt_lat = latency_bound(lambda cap: tracer.trace(words, origins, dirs, max_iters=cap), base)
    terrain = terrain_bricks(dev, card)

    # The slice's path once, counted: the brick build, raygen, the frame.
    torch.cuda.synchronize()
    kernels.reset_launches()
    dec2, br2 = bricks.build_bricks(words)
    origin2, dirs2 = camera.generate_rays_device(ci, W, H, dev)
    img_b, res_f, _ = tracer.render_frame(dec2, origin2, dirs2, bricks=br2, u8_image=True)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in ("brick_rows", "raygen", "trace",
                                                   "shade_encode")}
    check(all(v > 0 for v in launches.values()), f"a kernel never ran: {launches}")
    img_0, res_0, _ = tracer.render_frame(words, origin2, dirs2, u8_image=True)
    check(torch.equal(img_b, img_0) and all(torch.equal(a, b) for a, b in zip(res_f, res_0)),
          "the brick frame differs from the no-table frame")
    report["brick_rows"]["launches"] = launches["brick_rows"]
    report["trace"]["bricks"] = dict(
        entry, max_abs_err=max(errs), visits_exact=all(exact), frame_launches=launches["trace"],
        primary_ms=med["primary"], shadow_ms=med["shadow"], frame_ms=med["frame"],
        primary_range=prim["bricks"]["range"], no_table_trips=int(nt_v.sum()),
        loop_trips={k: {"total": v[0], "per_ray": v[0] / int((base.depth > 0).sum()),
                        "longest_at_most": v[1]} for k, v in trips.items()},
        no_table_rows=nt_rows, library_ms=None, split=split,
        split_share=split["split_warp_trips"] / max(split["warp_trips"], 1),
        no_table_latency_bound_ms=nt_lat["latency_bound_ms"], terrain=terrain, **lat,
        # Each byte the primary pass must move, once: the pool rows and the
        # brick rows (a 32-byte sector each) its trips read, the origin, each
        # direction in and 42 bytes of results out; beside it the no-table
        # form's, from its visits.
        **bound(tracer.k1_bytes(e["pool_rows"] + e["brick_rows"], n)),
        no_table_bound_ms=bound(tracer.k1_bytes(nt_rows, n))["bound_ms"])
    t = report["trace"]["bricks"]
    phase("9c K1 bricks", f"{card}: in turn, median ms: primary alone {med['primary']}; "
          f"shadow mode alone {med['shadow']}; shadowed u8 frame {med['frame']}; primary "
          f"marks: bricks {e['marks']}, no table {t['no_table_trips']}; loop trips (total, "
          f"a ray, the longest ray's within 16): {t['loop_trips']}; bound "
          f"{t['bound_ms']:.4f} ms (no table {t['no_table_bound_ms']:.4f}), latency "
          f"{t['latency_bound_ms']:.4f} ms (longest ray {t['longest_trips']} trips; no table "
          f"{t['no_table_latency_bound_ms']:.4f}); warp-trips {split['warp_trips']}, "
          f"{t['split_share']:.4f} split between brick trips and descents, lane-trips "
          f"brick {split['brick_lane_trips']} / descent {split['descent_lane_trips']}; the "
          f"slice's path (build_bricks, raygen, frame) launches {launches}, image and fields "
          f"equal to the no-table frame")

    # Paged pools: the relayout on the host, the frame through it.
    t0 = time.perf_counter()
    pg = paging.build_pages(words_np)
    pages_s = time.perf_counter() - t0
    geo = (pg.top_rows, pg.page_rows, pg.n_pages)
    pw = state.u32_to_device(pg.words, dev)
    old = torch.from_numpy(pg.old_of_new).to(dev)
    kernels.reset_launches()
    img_pg, res_pg, _ = tracer.render_frame(pw, origin2, dirs2, u8_image=True, paged=geo,
                                            paged_old_of_new=old)
    torch.cuda.synchronize()
    pg_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(torch.equal(img_pg, img_0), "the paged frame's image differs from the unpaged one")
    differ = [f for f, a, b in zip(res_pg._fields, res_pg, res_0) if not torch.equal(a, b)]
    check(not differ, f"the paged frame's {differ} differ from the unpaged frame's")
    paged_t = time_in_turn({
        "paged": lambda: tracer.trace(pw, origins, dirs, paged=geo),
        "original": lambda: tracer.trace(words, origins, dirs)}, 5, 10)
    report["trace"]["paged"] = dict(
        build_pages_s=pages_s, levels=pg.levels, top_rows=pg.top_rows,
        page_rows=pg.page_rows, n_pages=pg.n_pages, words=int(pg.words.shape[0]),
        frame_launches=pg_launches.get("trace", 0),
        primary_ms={k: v["median"] for k, v in paged_t.items()})
    phase("9c paged", f"{card}: build_pages on deep{DEPTH} ({n_words} words) in {pages_s:.2f} "
          f"s on the host: levels {pg.levels}, top {pg.top_rows} rows, {pg.n_pages} pages of "
          f"{pg.page_rows} rows ({pg.words.shape[0]} words); the paged frame (no table, "
          f"shadows, u8) equal to the unpaged one on every pixel and field after the remap; "
          f"launches {pg_launches}; primary alone, in turn: {paged_t}")


def gen_phases(dev, report, card) -> None:
    """Phases 13-15: K7 on the production chunk, generate_world of the CLI's
    default world, and Sessions over generated worlds."""
    from octree_tracer_tpu_torch import kernels, native, state
    from octree_tracer_tpu_torch.app.session import Session
    from octree_tracer_tpu_torch.gen import procedural
    from octree_tracer_tpu_torch.world.world import World

    # 13. K7 against its plain version on the production chunk and a second
    #     corner of the default world: every cell equal.
    s = 1 << GEN_DEPTH
    for corner in GEN_CORNERS:
        k_words = procedural.block_grid_packed(corner, GEN_DEPTH, 1, dev)
        p_words = procedural.block_grid_packed_plain(corner, GEN_DEPTH, 1, dev)
        n_diff = int((procedural.unpack_grid(k_words, GEN_DEPTH)
                      != procedural.unpack_grid(p_words, GEN_DEPTH)).sum())
        check(n_diff == 0, f"block_grid differs from plain on {n_diff} cells at {corner}")
    k_words = procedural.block_grid_packed(GEN_CORNER, GEN_DEPTH, 1, dev)
    # The bound counts the operations the grid needs with the permutation
    # and gradient from a table and the x-z terms once a column; the
    # algorithm's count, per point as it is stated, is kept beside it.
    ops = procedural.k7_ops(GEN_DEPTH)
    algorithm_ops = procedural.SDF_OPS * s * s * (s + 1)
    report["block_grid"].update(
        max_abs_err=0.0, differing_cells=0,
        ms=cuda_ms(lambda: procedural.block_grid_packed(GEN_CORNER, GEN_DEPTH, 1, dev), 5),
        plain_ms=cuda_ms(lambda: procedural.block_grid_packed_plain(
            GEN_CORNER, GEN_DEPTH, 1, dev), 2),
        library_ms=None, ops=ops, algorithm_ops=algorithm_ops,
        algorithm_bound_ms=bound(0, algorithm_ops)["bound_ms"], **bound(s ** 3 // 4, ops))
    t0 = time.perf_counter()
    host = k_words.cpu().numpy()
    ptrs, _ = native.build_dense(host, GEN_DEPTH)
    build_s = time.perf_counter() - t0
    filled = int((procedural.unpack_grid(k_words, GEN_DEPTH) != 0).sum())
    r = report["block_grid"]
    phase("13 K7", f"{s}^3 chunks at {' and '.join(map(str, GEN_CORNERS))}, base depth 1: "
          f"every cell equal to plain; {filled} filled cells at {GEN_CORNER}; kernel "
          f"{r['ms']:.3f} ms, plain {r['plain_ms']:.1f} ms, "
          f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}: {ops:.4g} f32 ops; the "
          f"algorithm's {algorithm_ops:.4g} would take {r['algorithm_bound_ms']:.3f} ms); readback "
          f"+ native.build_dense {ptrs.shape[0]} nodes in {build_s:.2f} s")

    # 14. generate_world of the CLI's default world, counted.
    root_dir = tempfile.mkdtemp(prefix="ot_genworld_")
    try:
        path = os.path.join(root_dir, "world")
        proc = procedural.Procedural(chunk_depth=GEN_DEPTH, device=dev)
        world = World(load_blocks=False)
        mip_s, save_s = [], []
        mip, save = world.generate_mip_tree, world.save_chunk

        def timed_mip(cid):
            t = time.perf_counter()
            mip(cid)
            mip_s.append(time.perf_counter() - t)

        def timed_save(cid):
            t = time.perf_counter()
            save(cid)
            save_s.append(time.perf_counter() - t)

        world.generate_mip_tree, world.save_chunk = timed_mip, timed_save
        kernels.reset_launches()
        t0 = time.perf_counter()
        world.generate_world(path, proc, world_depth=WORLD_DEPTH)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = kernels.LAUNCHES["block_grid"]
        check(launches == 8 ** WORLD_DEPTH, f"block_grid launched {launches} times")
        report["block_grid"]["launches"] = launches
        loaded = World.load_world(path, load_blocks=False)
        check(np.array_equal(loaded.chunks[0].pointers, world.chunks[0].pointers)
              and np.array_equal(loaded.chunks[0].values, world.chunks[0].values),
              "the reloaded root differs")
        files = sorted(os.listdir(path))
        mb = sum(os.path.getsize(os.path.join(path, f)) for f in files) / 2 ** 20
        tm = proc.timings
        phase("14 genworld", f"{card}: {len(files) - 1} chunks of {s}^3 + root in "
              f"{gen_s:.1f} s ({mb:.0f} MiB on disk); per chunk: K7 + readback wait "
              f"{[round(t['wait_s'], 3) for t in tm]} s, host build "
              f"{[round(t['build_s'], 2) for t in tm]} s, mip "
              f"{[round(t, 2) for t in mip_s]} s, save (IO pool) "
              f"{[round(t, 2) for t in save_s]} s; nodes {[t['nodes'] for t in tm]}; "
              f"K7 launches {launches}; root reloads equal")
        gen_session(dev, path, card)

        # 15b. CPU and CUDA Sessions in lockstep on a small generated world.
        small = os.path.join(root_dir, "small")
        World(load_blocks=False).generate_world(
            small, procedural.Procedural(chunk_depth=GEN_LOCK_DEPTH, device=dev), world_depth=1)
        pair = [Session(World.load_world(small, load_blocks=False), *LOCK_RES, device=d)
                for d in ("cpu", dev)]
        for s_ in pair:
            s_.character.pos = LOCK_POS.copy()
            s_.character.look = LOCK_LOOK.copy()
            s_.settings.fov = FOV
        before, loads, evictions = set(pair[0].world.chunks), 0, 0
        for i in range(GEN_LOCK_STEPS):
            if i == GEN_LOCK_TURN:
                for s_ in pair:
                    s_.character.turn(2400.0, 0.0, fov=FOV)
            (img_c, _, st_c), (img_g, _, st_g) = (s_.step() for s_ in pair)
            for s_ in pair:
                s_.world.wait_for_loads()
            check(torch.equal(img_c, img_g.cpu()), f"generated lockstep step {i}: images differ")
            check(st_c == st_g, f"generated lockstep step {i}: stats {st_c} vs {st_g}")
            check(torch.equal(pair[0].device_words, pair[1].device_words.cpu()),
                  f"generated lockstep step {i}: pools differ")
            now = set(pair[0].world.chunks)
            check(now == set(pair[1].world.chunks), f"generated lockstep step {i}: chunks")
            loads, evictions, before = loads + len(now - before), evictions + len(before - now), now
        check(loads > 0, "the generated lockstep loaded no chunk")
        phase("15 lockstep", f"CPU and CUDA Sessions equal at every step on a generated "
              f"chunk_depth {GEN_LOCK_DEPTH} world: {LOCK_RES[0]}x{LOCK_RES[1]}, "
              f"{GEN_LOCK_STEPS} steps, {loads} chunk loads, {evictions} evictions, "
              f"nodes {len(pair[1].octree)}; "
              f"{state.to_numpy_u32(pair[1].device_words).shape[0]} pool words")
    finally:
        shutil.rmtree(root_dir, ignore_errors=True)


def gen_session(dev, path, card) -> None:
    """Phase 15: the Session flying the generated world at 1080p until
    chunks have streamed in and, after it turns away, been evicted. After
    each step it waits for the chunk loads that step requested (a fly-through
    slow enough for the disk), timed apart from the step."""
    from octree_tracer_tpu_torch import kernels, state
    from octree_tracer_tpu_torch.app.session import Session
    from octree_tracer_tpu_torch.world.world import World

    world = World.load_world(path, load_blocks=False)
    sess = Session(world, W, H, device=dev)
    sess.character.pos = CAM_POS.copy()
    sess.character.look = CAM_LOOK.copy()
    sess.settings.fov = FOV
    kernels.reset_launches()
    before, loads, evictions = set(world.chunks), 0, 0
    step_ms, wait_ms, totals = [], [], {"subdivided": 0, "collapsed": 0, "patched": 0}
    for i in range(GEN_STEPS):
        if i == GEN_TURN:
            sess.character.look = -CAM_LOOK  # away from the whole world
        t0 = time.perf_counter()
        img, _, stats = sess.step()
        img.cpu()
        t1 = time.perf_counter()
        world.wait_for_loads()
        step_ms.append((t1 - t0) * 1e3)
        wait_ms.append((time.perf_counter() - t1) * 1e3)
        now = set(world.chunks)
        loads, evictions, before = loads + len(now - before), evictions + len(before - now), now
        for k in totals:
            totals[k] += stats[k]
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    for k in ("trace", "raygen", "shade_encode", "select_candidates"):
        check(launches.get(k, 0) > 0, f"{k} never ran on the generated-world Session")
    n_nodes, holes = sess.node_stats()
    pool = state.to_numpy_u32(sess.device_words)
    check(np.array_equal(pool[:n_nodes], sess.octree.nodes) and not pool[n_nodes:].any(),
          "the device pool differs from the host octree")
    check(loads > 0 and evictions > 0, f"chunks loaded {loads}, evicted {evictions}")
    check(totals["subdivided"] > 0 and totals["collapsed"] > 0, f"totals {totals}")
    phase("15 session", f"{card}: generated world ({GEN_DEPTH}+{WORLD_DEPTH} levels) "
          f"{W}x{H}, {GEN_STEPS} steps (turned away at {GEN_TURN}): {loads} chunk loads, "
          f"{evictions} evictions; median step {float(np.median(step_ms)):.1f} ms "
          f"(before the turn {float(np.median(step_ms[:GEN_TURN])):.1f}, max "
          f"{max(step_ms):.1f}); nodes {n_nodes}, bucket {sess.device_words.shape[0]}, "
          f"holes {holes:.2f}%; totals {totals}; launches {launches}; pool = host "
          f"octree; step ms {[round(t, 1) for t in step_ms]}; load waits ms "
          f"{[round(t) for t in wait_ms]}")


def probe_phase(dev, report) -> None:
    """Phase 16: the probes' gathers and adds at their shapes, counted."""
    from octree_tracer_tpu_torch import kernels
    from octree_tracer_tpu_torch.probes import gather, gather_probe

    kernels.reset_launches()
    results = gather_probe.main(device=dev, log=lambda m: phase("16 probes", m),
                                retimed=RETIMED, samples=RETIME_SAMPLES)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in ("gather_rows", "add_scalar")}
    check(all(v > 0 for v in launches.values()), f"a probe kernel never ran: {launches}")
    bad = [r["name"] for r in results if not (r["ok"] and r["plain_ok"])]
    check(not bad, f"probe lines failed: {bad}")
    # K8's word-by-word path: a width that is no multiple of 4, and a table
    # view that is not 16-byte aligned.
    rng = np.random.default_rng(3)
    odd = torch.from_numpy(rng.integers(-2**31, 2**31, (4000, 3), dtype=np.int32)).to(dev)
    flat = torch.from_numpy(rng.integers(-2**31, 2**31, 4 * 4000 + 1, dtype=np.int32)).to(dev)
    shifted = flat[1:].view(4000, 4)
    for t in (odd, shifted):
        starts = rng.integers(0, 4000 - 5, 777)
        st = gather.upload_starts(starts, dev)
        check(torch.equal(gather.gather_rows(t, st, 5), gather.gather_rows_plain(t, st.tensor, 5)),
              f"gather_rows differs from plain on a [4000, {t.shape[1]}] table")
    # K9's head and tail: a length that is no multiple of 4, and a view one
    # element off a 16-byte boundary; f32 and u32, the scalar by value and
    # by pointer.
    for dtype, c in ((torch.float32, 0.75), (torch.int32, -3)):
        base = torch.from_numpy(rng.standard_normal(4 * 4000 + 4).astype(np.float32)).to(dev)
        if dtype == torch.int32:
            base = base.view(torch.int32)
        for x in (base[:4 * 4000 + 3], base[1:]):
            for scalar in (c, torch.tensor([c], dtype=dtype, device=dev)):
                check(torch.equal(gather.add_scalar(x, scalar), gather.add_scalar_plain(x, scalar)),
                      f"add_scalar differs from plain on {dtype} [{x.numel()}] at offset "
                      f"{x.storage_offset()} (scalar {type(scalar).__name__})")
    phase("16 probes", "K8 equal to plain on a width-3 table and a misaligned width-4 view; "
          "K9 equal to plain on 16,003 elements and a view one element off 16 bytes, f32 "
          "and u32, the scalar by value and by pointer")
    for r in results:
        if "retimed" in r:
            t = r["retimed"]
            k_lo, k_hi = t["ms_range"]
            l_lo, l_hi = t["library_ms_range"]
            loss = t["ms_median"] - t["library_ms_median"]
            spread = max(k_hi - k_lo, l_hi - l_lo)
            phase("16 retimed", f"{r['name']}: {r['kernel']} median {t['ms_median'] * 1e3:.3f} "
                  f"us [{k_lo * 1e3:.3f}, {k_hi * 1e3:.3f}], {r['library']} median "
                  f"{t['library_ms_median'] * 1e3:.3f} us [{l_lo * 1e3:.3f}, {l_hi * 1e3:.3f}] "
                  f"over {t['samples']} samples each, in turn; kernel - library "
                  f"{loss * 1e3:+.3f} us, spread {spread * 1e3:.3f} us: "
                  f"{'a loss beyond the spread' if loss > spread else 'within the spread'}")
    for kernel, line in (("gather_rows", "A per-row DMA K=8"), ("add_scalar", "t3")):
        r = next(r for r in results if r["name"] == line)
        report[kernel].update(
            launches=launches[kernel], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], library_ms=r["library_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", shape_of=line)


def decode_png(data: bytes) -> np.ndarray:
    """The pixels u8[H, W, 3] of an 8-bit RGB PNG whose rows all use filter
    0, as ``app.headless.png_bytes`` writes them; every chunk's CRC is
    checked."""
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, shape = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(zlib.crc32(tag + body) == crc, f"bad CRC in the PNG's {tag} chunk")
        if tag == b"IHDR":
            w, h, bits, colour = struct.unpack(">IIBB", body[:10])
            check(bits == 8 and colour == 2, f"PNG of {bits} bits, colour type {colour}")
            shape = (h, w)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    h, w = shape
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "a PNG row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def run_cli(args: list, env: dict | None = None) -> tuple[str, float, dict]:
    """Run ``python -m octree_tracer_tpu_torch.app.cli`` from the repository
    root with ``args``; returns (standard output, seconds, each kernel's
    launches in that process). Raises if it fails."""
    fd, counts = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "octree_tracer_tpu_torch.app.cli", "--launch-counts",
             counts, *map(str, args)], cwd=REPO, env=dict(os.environ, **(env or {})),
            capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli {args[0]} failed ({proc.returncode}):\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(counts) as f:
            launches = {k: v for k, v in json.load(f).items() if v}
    finally:
        os.remove(counts)
    return proc.stdout, secs, launches


def app_phases(dev, report, card) -> None:
    """Phases 17-21: io round trips, the CLI's render, bench, genworld
    --structures and fly as a user runs them, and the HTTP viewer, at
    1920x1080 on the card; each path's launches go into the report."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from octree_tracer_tpu_torch import kernels, scenes, state
    from octree_tracer_tpu_torch.app.session import Session
    from octree_tracer_tpu_torch.app.viewer import ViewerServer, make_handler
    from octree_tracer_tpu_torch.gen import procedural
    from octree_tracer_tpu_torch.io import load_file
    from octree_tracer_tpu_torch.io.rsvo_export import save_rsvo
    from octree_tracer_tpu_torch.io.vox_export import save_vox, tree_to_cells
    from octree_tracer_tpu_torch.render import camera, tracer
    from octree_tracer_tpu_torch.world.world import World

    paths = {}

    def record(path, launches):
        paths[path] = launches
        for k, v in launches.items():
            report[k].setdefault("app_launches", {})[path] = v

    tmp = tempfile.mkdtemp(prefix="ot_app_")
    try:
        # 17. io: deep10 through .rsvo (its masks), a generated chunk
        #     through .vox (every filled cell and colour).
        rsvo_path = os.path.join(tmp, f"deep{DEPTH}.rsvo")
        chunk = scenes.shell_chunk(DEPTH)
        t0 = time.perf_counter()
        data = save_rsvo(chunk)
        with open(rsvo_path, "wb") as f:
            f.write(data)
        t1 = time.perf_counter()
        back = load_file(rsvo_path, DEPTH)
        t2 = time.perf_counter()
        check(save_rsvo(back) == data, "deep10's masks differ after the .rsvo round trip")
        assets = scenes.write_asset_root(os.path.join(tmp, "assets"))
        world = World(asset_root=assets)
        kernels.reset_launches()
        gen = procedural.Procedural(chunk_depth=APP_VOX_DEPTH, device=dev).generate_chunk(
            GEN_CORNER, 1)
        torch.cuda.synchronize()
        record("gen_chunk8", {k: v for k, v in kernels.LAUNCHES.items() if v})
        world.chunks[APP_GEN_ID] = gen
        world.generate_mip_tree(APP_GEN_ID)  # block references take their blocks' colours
        vox_path = os.path.join(tmp, "chunk8.vox")
        t3 = time.perf_counter()
        vdata = save_vox(gen, APP_VOX_DEPTH)
        with open(vox_path, "wb") as f:
            f.write(vdata)
        t4 = time.perf_counter()
        vback = load_file(vox_path)
        t5 = time.perf_counter()
        cells = []
        for tree in (gen, vback):
            c, rgb = tree_to_cells(tree, APP_VOX_DEPTH)
            key = (c[:, 0].astype(np.int64) << 16) | (c[:, 1].astype(np.int64) << 8) | c[:, 2]
            order = np.argsort(key)
            cells.append((key[order], rgb[order]))
        check(cells[0][0].size > 0 and np.array_equal(cells[0][0], cells[1][0])
              and np.array_equal(cells[0][1], cells[1][1]),
              "the generated chunk's filled cells differ after the .vox round trip")
        phase("17 io", f"deep{DEPTH} .rsvo: {len(data):,} bytes, save {t1 - t0:.3f} s, "
              f"load {t2 - t1:.3f} s, masks equal; generated {1 << APP_VOX_DEPTH}^3 chunk "
              f".vox: {len(vdata):,} bytes, save {t4 - t3:.3f} s, load {t5 - t4:.3f} s, "
              f"{cells[0][0].size} filled cells and colours equal; launches {paths['gen_chunk8']}")

        # 18. The CLI's render and bench of deep10.rsvo at 1920x1080: the
        #     PNG is a direct render_frame's u8 frame, pixel for pixel.
        cam = f"{','.join(map(str, CAM_POS))}:{','.join(map(str, CAM_LOOK))}"
        png_path = os.path.join(tmp, "render.png")
        out, secs, launches = run_cli(["render", rsvo_path, "--depth", DEPTH, "--width", W,
                                       "--height", H, "--fov", FOV, "--camera", cam,
                                       "-o", png_path])
        record("render", launches)
        with open(png_path, "rb") as f:
            png = f.read()
        img = decode_png(png)
        ci = camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)[1]
        origin, dirs = camera.generate_rays_device(ci, W, H, dev)
        direct, res, _ = tracer.render_frame(state.u32_to_device(back.to_words(), dev),
                                             origin, dirs, u8_image=True)
        differ = int(np.any(img != direct.cpu().numpy(), axis=-1).sum())
        check(differ == 0, f"the CLI's PNG differs from render_frame on {differ} pixels")
        check(all(launches.get(k, 0) > 0 for k in ("trace", "raygen", "shade_encode")),
              f"render launched {launches}")
        out_b, secs_b, launches_b = run_cli(["bench", "--scene", rsvo_path, "--depth", DEPTH,
                                             "--width", W, "--height", H, "--fov", FOV,
                                             "--camera", cam])
        record("bench", launches_b)
        bench = json.loads(out_b.strip().splitlines()[-1])
        check(bench["hits"] == int(res.hit.sum()), f"bench hits {bench['hits']}")
        phase("18 render", f"{card}: cli render deep{DEPTH}.rsvo {W}x{H} in {secs:.1f} s "
              f"(process): {out.strip()}; PNG {len(png):,} bytes equal to render_frame's "
              f"u8 frame on every pixel; launches {launches}")
        phase("18 bench", f"{card}: cli bench in {secs_b:.1f} s (process), launches "
              f"{launches_b}: {json.dumps(bench)}")

        # 19. genworld --structures at the CLI's defaults with the synthetic
        #     asset root; then a CPU and a CUDA world at chunk_depth 5 with
        #     structures, file for file.
        env = {"OT_ASSET_ROOT": assets}
        world_dir = os.path.join(tmp, "world")
        out, secs, launches = run_cli(["genworld", world_dir, "--structures"], env)
        record("genworld", launches)
        per_chunk = re.findall(r"chunks generated \((.*)\)", out)
        stamped = sum(int(m) for m in re.findall(r"(\d+) blocks stamped", out))
        check(len(per_chunk) == 8 and stamped > 0 and launches.get("block_grid") == 8,
              f"genworld --structures: {len(per_chunk)} chunks, {stamped} blocks stamped, "
              f"launches {launches}")
        pair = {}
        for d in ("cpu", dev):
            path = os.path.join(tmp, f"small_{torch.device(d).type}")
            p = procedural.Procedural(chunk_depth=GEN_LOCK_DEPTH, structures=True, device=d,
                                      asset_root=assets)
            World(asset_root=assets).generate_world(path, p, world_depth=1)
            pair[d] = (path, sum(t["stamped"] for t in p.timings))
        (cpu_path, cpu_stamped), (gpu_path, gpu_stamped) = pair.values()
        names = sorted(os.listdir(cpu_path))
        check(sorted(os.listdir(gpu_path)) == names and cpu_stamped == gpu_stamped > 0,
              f"CPU and CUDA worlds: {names}, stamped {cpu_stamped} and {gpu_stamped}")
        for name in names:
            with open(os.path.join(cpu_path, name), "rb") as a, \
                    open(os.path.join(gpu_path, name), "rb") as b:
                check(a.read() == b.read(), f"CPU and CUDA chunk {name} differ")
        phase("19 genworld", f"{card}: cli genworld --structures (chunk_depth {GEN_DEPTH}, "
              f"world_depth {WORLD_DEPTH}) in {secs:.1f} s (process), {stamped} blocks "
              f"stamped; per chunk: {per_chunk}; launches {launches}; CPU and CUDA "
              f"chunk_depth {GEN_LOCK_DEPTH} worlds with structures byte-equal in "
              f"{len(names)} files, {gpu_stamped} blocks stamped")

        # 20. fly over that world with the block library, 1920x1080.
        out, secs, launches = run_cli(["fly", world_dir, "--width", W, "--height", H,
                                       "--frames", FLY_FRAMES, "-o",
                                       os.path.join(tmp, "fly_%d.png")], env)
        record("fly", launches)
        ticks = [float(m) for m in re.findall(r"frame \d+: (\d+) ms", out)]
        summary = out.strip().splitlines()[-1]
        loads, evictions, deepest = map(int, re.findall(r"\d+", summary))
        saved = sorted(f for f in os.listdir(tmp) if f.startswith("fly_"))
        for f in saved:
            with open(os.path.join(tmp, f), "rb") as fh:
                check(decode_png(fh.read()).shape == (H, W, 3), f"{f} is not {W}x{H}")
        check(len(ticks) == FLY_FRAMES and loads > 0 and deepest > 0
              and launches.get("trace", 0) > 0 and launches.get("select_candidates", 0) > 0,
              f"fly: {len(ticks)} frames, {summary}, launches {launches}")
        phase("20 fly", f"{card}: cli fly {W}x{H}, {FLY_FRAMES} frames in {secs:.1f} s "
              f"(process): tick median {float(np.median(ticks)):.0f} ms (first 10 "
              f"{float(np.median(ticks[:10])):.0f}, last 10 {float(np.median(ticks[-10:])):.0f});"
              f" {summary}; {len(saved)} PNGs of {W}x{H}; launches {launches}; "
              f"ticks ms {ticks}")

        # 21. The HTTP viewer over that world: the page, frames, steps with
        #     movement and toggles, an Open of deep10.rsvo and a Regenerate.
        kernels.reset_launches()  # the viewer's count covers its Session's start
        sess = Session(World.load_world(world_dir, asset_root=assets), W, H, device=dev)
        server = ViewerServer(sess)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        steps = [{"forward": 1.0, "right": 0.5 * (i % 2), "look": [30, 0] if i == 3 else [0, 0],
                  "shadows": i != 5, "show_steps": i == 6, "show_hits": i == 7,
                  "feedback_every": 2 if i == 4 else 1, "octree_depth": DEPTH}
                 for i in range(VIEW_STEPS)]
        plan = ([("GET", "/", None), ("GET", "/frame.png", None)]
                + [("POST", "/step", b) for b in steps]
                + [("POST", "/open", {"path": rsvo_path}),
                   ("POST", "/regenerate", {"chunk_depth": GEN_LOCK_DEPTH, "structures": True})])
        latencies = []
        try:
            for method, path, body in plan:
                data = None if body is None else json.dumps(body).encode()
                req = urllib.request.Request(base + path, data=data, method=method)
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=600) as r:
                    status, reply = r.status, r.read()
                latencies.append((f"{method} {path}", round((time.perf_counter() - t0) * 1e3, 1)))
                check(status == 200, f"{method} {path} answered {status}")
                if path in ("/open", "/regenerate"):
                    msg = json.loads(reply)["message"]
                    check(msg.startswith("loaded" if path == "/open" else "regenerated"), msg)
                if method == "POST" or path == "/frame.png":
                    with urllib.request.urlopen(base + "/frame.png", timeout=60) as r:
                        check(r.status == 200 and decode_png(r.read()).shape == (H, W, 3),
                              f"the frame after {path} is not a {W}x{H} PNG")
        finally:
            httpd.shutdown()
            httpd.server_close()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        record("viewer", launches)
        check(all(launches.get(k, 0) > 0 for k in ("trace", "raygen", "shade_encode",
                                                   "select_candidates", "block_grid")),
              f"viewer launched {launches}")
        phase("21 viewer", f"{card}: {W}x{H} Session behind ThreadingHTTPServer: every "
              f"answer 200 and every frame a {W}x{H} PNG; latency ms {latencies}; "
              f"launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean host ms per call of ``fn``, the card synchronised before and
    after the calls (gloo's collectives wait on the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def frame_digests(img, result, visits) -> dict:
    out = {"img": digest(img), "visits": digest(visits)}
    out.update({f: digest(getattr(result, f)) for f in result._fields})
    return out


def collective_costs(mesh, words, table, origin, dirs, payload_words=None) -> dict:
    """ms of the sharded counted frame's parts on this rank, as the Session
    renders it (shadows, flags, the table, u8), on all ranks together after
    a barrier (ranks that share a card share its time): the whole frame and
    the rank's own rows through ``render_frame``, the visit
    all-reduce (the pool's int32), the frame all-gather (result and image),
    a step message's broadcast (its head and ``payload_words`` of payload,
    when given) and the whole ``render_frame_sharded``."""
    import torch.distributed as dist

    from octree_tracer_tpu_torch.parallel import mesh as pmesh
    from octree_tracer_tpu_torch.parallel import session as psession
    from octree_tracer_tpu_torch.render import tracer

    args = dict(shadows=True, warp_table=table, u8_image=True, with_visits=True,
                visit_flags=True)
    rows = pmesh.shard_rows(mesh, dirs)
    img, res, visits = tracer.render_frame(words, origin, rows, **args)
    buf = torch.zeros_like(visits)
    parts = {"whole_frame": lambda: tracer.render_frame(words, origin, dirs, **args),
             "local_frame": lambda: tracer.render_frame(words, origin, rows, **args),
             "visit_all_reduce": lambda: pmesh.all_reduce_visits(mesh, buf),
             "frame_all_gather": lambda: pmesh.gather_frame(mesh, img, res),
             "sharded_frame": lambda: pmesh.render_frame_sharded(mesh, words, origin, dirs,
                                                                 **args)}
    if payload_words is not None:
        head = torch.zeros(psession._HEAD, dtype=torch.int64, device=mesh.device)
        payload = torch.zeros(max(payload_words, 1), dtype=torch.int32, device=mesh.device)
        parts["step_broadcast"] = lambda: (mesh.broadcast(head, "timing"),
                                           mesh.broadcast(payload, "timing"))
    out = {"rows": rows.shape[0], "pool_words": int(words.shape[0])}
    for name, fn in parts.items():
        dist.barrier(group=mesh.group)
        out[name] = wall_ms(fn, SHARD_TIMED)
    return out


def session_rank(mesh, steps: int) -> dict:
    """A rank of phase 22c: a ShardedSession on the deep10 shell world at
    1920x1080 (rank 0 owns the world), ``steps`` steps; the step records,
    the rank's launches and ``collective_costs`` on its last pool."""
    from octree_tracer_tpu_torch import kernels, scenes
    from octree_tracer_tpu_torch.parallel import ShardedSession
    from octree_tracer_tpu_torch.render import camera, skip

    world = scenes.shell_world(DEPTH) if mesh.rank == 0 else None
    sess = ShardedSession(world, mesh, W, H)
    sess.character.pos, sess.character.look = CAM_POS.copy(), CAM_LOOK.copy()
    sess.settings.fov = FOV
    mesh.traffic.clear()
    kernels.reset_launches()
    recs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        img, _, stats = sess.step()
        host = img.cpu()
        recs.append(step_record(sess, host, stats, (time.perf_counter() - t0) * 1e3))
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    traffic = {k: dict(v) for k, v in mesh.traffic.items()}
    ci = camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)[1]
    origin, dirs = camera.generate_rays_device(ci, W, H, mesh.device)
    table = skip.build_warp_skip_table(sess.device_words, LEVELS)
    costs = collective_costs(mesh, sess.device_words, table, origin, dirs,
                             traffic.get("message_payload", {}).get("max_bytes", 0) // 4)
    return {"steps": recs, "launches": launches, "traffic": traffic, "costs": costs}


def frame_rank(mesh) -> dict:
    """A rank of phase 22c's frame: phase 8's deep10 frame (pool and table
    from rank 0 by ``replicate``) through ``render_frame_sharded``, plain
    and counted; digests, launches and ``collective_costs``."""
    from octree_tracer_tpu_torch import kernels, scenes, state
    from octree_tracer_tpu_torch.parallel import mesh as pmesh
    from octree_tracer_tpu_torch.render import camera, skip

    words = pmesh.replicate(mesh, state.u32_to_device(scenes.deep_shell(DEPTH), mesh.device)
                            if mesh.rank == 0 else None)
    table = pmesh.replicate(mesh, skip.build_warp_skip_table(words, LEVELS)
                            if mesh.rank == 0 else None)
    ci = camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)[1]
    torch.cuda.synchronize()
    kernels.reset_launches()
    origin, dirs = camera.generate_rays_device(ci, W, H, mesh.device)
    args = dict(shadows=True, warp_table=table, u8_image=True)
    img, res, _ = pmesh.render_frame_sharded(mesh, words, origin, dirs, **args)
    visits = pmesh.render_frame_sharded(mesh, words, origin, dirs, with_visits=True, **args)[2]
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    return {"digests": frame_digests(img, res, visits), "launches": launches,
            "costs": collective_costs(mesh, words, table, origin, dirs)}


def sharded_phases(dev, report, card, words, table, ci, ref) -> None:
    """Phase 22: the sharded frame and ShardedSession. (a) An in-process
    NCCL group of world size 1: phase 8's frame through
    ``render_frame_sharded`` equal to ``render_frame`` on every pixel, result
    field and visit, counts and flags; (b) a ShardedSession of 24 steps equal
    to phase 11's Session at every step; (c) two gloo ranks sharing the
    card: a ShardedSession of 24 steps (the table from step 18, as phase
    11's), both ranks equal to phase 11's, and four ranks' frame equal to
    ``render_frame``; (d) the
    dryrun at two ranks. The collective costs by part beside each."""
    import torch.distributed as dist

    from octree_tracer_tpu_torch import kernels, scenes
    from octree_tracer_tpu_torch.parallel import (
        ShardedSession, dryrun_multichip, make_mesh, run_ranks)
    from octree_tracer_tpu_torch.parallel import mesh as pmesh
    from octree_tracer_tpu_torch.render import camera, skip, tracer

    def record(path, rank, launches):
        for k, v in launches.items():
            report[k].setdefault("sharded_launches", {}).setdefault(path, {})[f"rank{rank}"] = v

    def same_steps(recs, what):
        for i, (a, b) in enumerate(zip(recs, ref)):
            for key in ("img", "pool", "table", "stats", "node_stats", "sel_offset"):
                check(a[key] == b[key], f"{what} step {i}: {key} differs from phase 11's "
                      f"Session ({a[key]} vs {b[key]})")

    def median(recs, last=None):
        return float(np.median([r["ms"] for r in recs[-last if last else 0:]]))

    def costs_text(c):
        return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                         for k, v in c.items())

    frame_args = dict(shadows=True, warp_table=table, u8_image=True)
    origin, dirs = camera.generate_rays_device(ci, W, H, dev)
    img_u, res_u, _ = tracer.render_frame(words, origin, dirs, **frame_args)
    visits_u = {flags: tracer.render_frame(words, origin, dirs, with_visits=True,
                                           visit_flags=flags, **frame_args)[2]
                for flags in (False, True)}
    want = frame_digests(img_u, res_u, visits_u[False])

    tmp = tempfile.mkdtemp(prefix="ot_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device=dev)
        # 22a. The frame at world size 1.
        torch.cuda.synchronize()
        kernels.reset_launches()
        o_s, d_s = camera.generate_rays_device(ci, W, H, dev)
        img, res, _ = pmesh.render_frame_sharded(mesh, words, o_s, d_s, **frame_args)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        record("frame_ws1", 0, launches)
        check(all(launches.get(k, 0) > 0 for k in ("trace", "raygen", "shade_encode")),
              f"the sharded frame launched {launches}")
        check(torch.equal(img, img_u), f"the sharded frame differs from render_frame on "
              f"{int((img != img_u).any(-1).sum())} pixels")
        for f in res._fields:
            check(torch.equal(getattr(res, f), getattr(res_u, f)), f"sharded {f} differs")
        for flags in (False, True):
            v = pmesh.render_frame_sharded(mesh, words, origin, dirs, with_visits=True,
                                           visit_flags=flags, **frame_args)[2]
            check(torch.equal(v, visits_u[flags]), f"sharded visits (flags {flags}) differ "
                  f"on {int((v != visits_u[flags]).sum())} slots")
        phase("22a sharded frame", f"{card}: NCCL, world size 1: deep{DEPTH} {W}x{H} shadows "
              f"+ combined L{LEVELS} u8 equal to render_frame on every pixel and result "
              f"field, visits equal in counts and flags; launches {launches}")

        # 22b. The Session at world size 1, against phase 11's.
        t0 = time.perf_counter()
        sess = ShardedSession(scenes.shell_world(DEPTH), mesh, W, H)
        sess.character.pos, sess.character.look = CAM_POS.copy(), CAM_LOOK.copy()
        sess.settings.fov = FOV
        setup_s = time.perf_counter() - t0
        mesh.traffic.clear()
        torch.cuda.synchronize()
        kernels.reset_launches()
        recs = []
        for _ in range(SESSION_STEPS):
            t0 = time.perf_counter()
            img, _, stats = sess.step()
            host = img.cpu()
            recs.append(step_record(sess, host, stats, (time.perf_counter() - t0) * 1e3))
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        record("session_ws1", 0, launches)
        check(all(launches.get(k, 0) > 0 for k in SESSION_KERNELS),
              f"a kernel never ran on the sharded Session path: {launches}")
        same_steps(recs, "world size 1")
        traffic = {k: dict(v) for k, v in mesh.traffic.items()}
        payload = traffic.get("message_payload", {}).get("max_bytes", 0)
        costs = collective_costs(mesh, sess.device_words,
                                 skip.build_warp_skip_table(sess.device_words, LEVELS),
                                 origin, dirs, payload // 4)
        del sess
        phase("22b sharded session", f"{card}: NCCL, world size 1: ShardedSession on the "
              f"deep{DEPTH} shell world {W}x{H}, setup {setup_s:.1f} s, {SESSION_STEPS} steps "
              f"equal to phase 11's Session at every step (u8 frames, pools, tables, stats, "
              f"node_stats, selection offsets); median step {median(recs):.1f} ms (phase "
              f"11: {median(ref):.1f}), last 8 {median(recs, 8):.1f} ms (phase 11: "
              f"{median(ref, 8):.1f}); largest step payload {payload / 1e3:.1f} KB; "
              f"traffic {traffic}; launches {launches}; step ms "
              f"{[round(r['ms'], 1) for r in recs]}")
        phase("22b costs", f"{card}: world size 1, the last step's pool, ms a call: "
              f"{costs_text(costs)}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    # 22c. Two gloo ranks sharing the card: the Session; four: the frame.
    t0 = time.perf_counter()
    ranks = run_ranks(session_rank, 2, dev.type, SESSION_STEPS)
    secs = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        same_steps(out["steps"], f"gloo rank {r} of 2")
        record("session_ws2", r, out["launches"])
    check(all(ranks[0]["launches"].get(k, 0) > 0 for k in SESSION_KERNELS),
          f"rank 0 launched {ranks[0]['launches']}")
    check(all(ranks[1]["launches"].get(k, 0) > 0 for k in FRAME_KERNELS)
          and not any(ranks[1]["launches"].get(k) for k in ("select_candidates",
                                                             "propagate_visits")),
          f"rank 1 launched {ranks[1]['launches']}: it renders and replays, never selects")
    for r, out in enumerate(ranks):
        phase("22c two ranks", f"{card}: gloo, rank {r} of 2 on {dev} ({H // 2} rows): "
              f"{SESSION_STEPS} ShardedSession steps equal to phase 11's (u8 frames, pools, "
              f"tables, stats, node_stats, selection offsets); median step "
              f"{median(out['steps']):.1f} ms (phase 11: {median(ref):.1f}), last 8 "
              f"{median(out['steps'], 8):.1f} ms (phase 11: {median(ref, 8):.1f}); "
              f"launches {out['launches']}; traffic "
              f"{out['traffic']}; costs, ms a call: {costs_text(out['costs'])}; step ms "
              f"{[round(x['ms'], 1) for x in out['steps']]}")
    phase("22c two ranks", f"both ranks in {secs:.1f} s (process start, world, steps, costs)")
    frames = run_ranks(frame_rank, 4, dev.type)
    for r, out in enumerate(frames):
        check(out["digests"] == want, f"rank {r} of 4: the frame differs from render_frame "
              f"in {[k for k in want if out['digests'][k] != want[k]]}")
        record("frame_ws4", r, out["launches"])
        check(all(out["launches"].get(k, 0) > 0 for k in ("trace", "raygen", "shade_encode")),
              f"rank {r} of 4 launched {out['launches']}")
        phase("22c four ranks", f"{card}: gloo, rank {r} of 4 ({H // 4} rows): deep{DEPTH} "
              f"frame (pool and table replicated from rank 0) equal to render_frame on "
              f"every pixel, result field and counted visit; launches {out['launches']}; "
              f"costs, ms a call: {costs_text(out['costs'])}")

    # 22d. The dryrun, two ranks on the card.
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device=dev.type)
    phase("22d dryrun", f"{card}: dryrun_multichip(2) in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(dry)}")


if __name__ == "__main__":
    sys.exit(main())
