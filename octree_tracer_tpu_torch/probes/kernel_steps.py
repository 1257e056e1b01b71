"""K7, K3, K5, K4 and K2 across source trees: the island SDF grid, ray
generation, candidate selection, shading and the warp table and occupancy
of several versions of the port, timed in turn on one card.

    python -m octree_tracer_tpu_torch.probes.kernel_steps TREE [TREE ...] \\
        [--rounds R] [--kernels k7,k3,k5,k4,k2] [--unchecked TREE ...] [--out DIR]

Each TREE is a directory holding an ``octree_tracer_tpu_torch`` package: a
``git archive`` of an earlier commit, or a copy of this tree with one change.
Each tree's worker (see ``probes/trees.py``) builds its kernels and makes,
with its own kernels, what the chosen kernels read, and hashes it all: for
K7 the 8 chunk grids of the CLI's default world (chunk_depth 9, world_depth
1; the first is the production chunk at (-1, -1, -1)); for K3 the bench
camera's 1920x1080 rays; for K5 and K4 the deep10 frame at 1920x1080 with
the combined level-7 table (its primary result, shadow hits and counted
visits, as ``chip_smoke.py`` phases 7, 9 and 10 make them); for K2 its
warp words and occupancy at level 7 of the deep10 pool and of the
production chunk's pool (the CLI's default world's first chunk, as
``Procedural.generate_chunk`` builds it), and at every level from 0 to 9
of the deep10 pool. The workers
then measure in turn, A B B A on the same card. The trees need only the
port's public API (``procedural.block_grid_packed``,
``camera.generate_rays_device``, ``tracer.trace``, ``tracer.trace_shadow``,
``tracer.shade``, ``tracer.warp_occupancy``, ``skip.build_warp_skip_table``,
``feedback.select_candidates_packed``, ``Procedural.generate_chunk``,
``gather_probe.cuda_ms``).

Per tree and round, in ms a call:

- ``k7``: K7 on the production chunk (CUDA events, mean of 5 launches after
  one warm-up);
- ``k7_world``: the 8 chunk grids of one ``generate_world``, mean a chunk;
- ``k3``: K3 alone, device time: the calls are queued behind a spin
  kernel that lasts twice their measured enqueue time, so the host's launch
  cost is hidden (mean of 50, by the tree's own ``probes/gather_probe.py``
  ``cuda_ms``, which ``chip_smoke.py`` uses too). A tree whose
  ``camera`` has ``_raygen_args`` takes the matrix by value, from NumPy; an
  earlier tree gets it already on the card as a CUDA tensor, so neither
  pays a copy;
- ``k3_render``: K3 as ``Session.render`` calls it, from a NumPy matrix,
  back to back (CUDA events, mean of 50 after 5 warm-ups): the launch, and
  in a tree that copies the matrix to the card, the copy and its wait;
- ``k5``, ``k5_small``: K5 on the deep10 pool and its counted visits at
  phase 10's two shapes, caps 65536/65536 (the Session's) from offset
  123457 and caps 1024/1024 from offset 777, device time as ``k3``;
- ``k4_u8``, ``k4_f32``: K4 on the frame's result and shadow hits, the u8
  frame and the f32 image, device time as ``k3``;
- ``k2``, ``k2_chunk``: K2 at level 7 on the deep10 pool and on the
  production chunk's pool, device time as ``k3``; beside them two floors
  of this timing on this card: ``k2_l1``, K2 at level 1 (one thread, so
  what a launch costs), and ``k2_fill``, one ``fill_`` of the bytes K2
  writes at level 7 (what one launch that only stores them takes).

Every tree must give the first tree's outputs bit for bit (grids,
directions and origin; the frame inputs; K5's packed lists; K4's u8 and
f32 frames; K2's warp words and occupancy); the probe exits 1 if one does
not, except for the trees named by ``--unchecked`` (timing-only copies,
whose hashes are printed). It
prints the median and range over rounds and each tree's registers and
spills of the chosen kernels, and writes all samples to
``DIR/kernel_steps.json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

W, H = 1920, 1080
CAM_POS = np.array([0.2, 0.3, -2.4], np.float32)  # bench.py:255-257
CAM_LOOK = np.array([-0.1, -0.15, 1.0], np.float32)
FOV = 70.0
GEN_DEPTH, WORLD_DEPTH = 9, 1
# generate_world's chunk corners in its order (world/world.py cell_pos).
CORNERS = [(x, y, z) for x in (-1.0, 0.0) for y in (-1.0, 0.0) for z in (-1.0, 0.0)]
K7_REPS, K3_REPS, K45_REPS, K2_REPS = 5, 50, 50, 50
DEPTH, LEVELS = 10, 7
# chip_smoke.py phase 10's selections: (sub_cap, unsub_cap, offset).
K5_CASES = {"k5": (65536, 65536, 123457), "k5_small": (1024, 1024, 777)}
METRICS = {"k7": ("k7", "k7_world"), "k3": ("k3", "k3_render"),
           "k5": tuple(K5_CASES), "k4": ("k4_u8", "k4_f32"),
           "k2": ("k2", "k2_chunk", "k2_l1", "k2_fill")}
# Source files whose ptxas lines are reported, by kernel.
SOURCES = {"k7": "block_grid", "k3": "raygen", "k5": "select", "k4": "shade",
           "k2": "warp_occupancy"}


# A worker loads this file by path beside an older tree's package, so the
# helpers below are its own (as trace_steps' are); device time is the tree's.
def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Mean ms a call of back-to-back calls of ``fn``, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _frame(dev):
    """The deep10 1080p frame's K4 and K5 inputs, made by the tree's own
    kernels: pool words, primary result, shadow hits, counted visits."""
    import torch
    from octree_tracer_tpu_torch import scenes, state
    from octree_tracer_tpu_torch.render import camera, skip, tracer

    words = state.u32_to_device(scenes.deep_shell(DEPTH), dev)
    table = skip.build_warp_skip_table(words, LEVELS)
    ci = camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)[1]
    origin, dirs = camera.generate_rays_device(ci, W, H, dev)
    origins = origin.reshape(1, 3).expand(W * H, 3)
    res = tracer.trace(words, origins, dirs, warp_table=table)
    shadow = tracer.trace_shadow(words, res, warp_table=table, image_width=W)
    counts = torch.zeros(words.shape[0], dtype=torch.int32, device=dev)
    tracer.trace(words, origins, dirs, warp_table=table, visits=counts)
    return words, res, shadow, counts


def setup(kernels_csv="k7,k3,k5,k4,k2"):
    """In a worker: build the tree's kernels, make and hash what the chosen
    kernels read and write; each request measures them."""
    import torch
    from octree_tracer_tpu_torch import kernels
    from octree_tracer_tpu_torch.probes.gather_probe import cuda_ms as device_ms

    chosen = kernels_csv.split(",")
    dev = torch.device("cuda", 0)
    _, log = kernels.build()
    kernels.library()
    digest, timed, extra = {}, {}, {}
    if "k7" in chosen:
        from octree_tracer_tpu_torch.gen import procedural

        grids = [procedural.block_grid_packed(c, GEN_DEPTH, WORLD_DEPTH, dev)
                 for c in CORNERS]
        digest.update(k7_production=_digest(grids[0]), k7_world=_digest(*grids))
        del grids

        def world():
            for c in CORNERS:
                procedural.block_grid_packed(c, GEN_DEPTH, WORLD_DEPTH, dev)

        timed["k7"] = lambda: cuda_ms(
            lambda: procedural.block_grid_packed(CORNERS[0], GEN_DEPTH, WORLD_DEPTH, dev),
            K7_REPS, 1)
        timed["k7_world"] = lambda: cuda_ms(world, 1, 1) / len(CORNERS)
    if "k3" in chosen:
        from octree_tracer_tpu_torch.render import camera

        ci = camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)[1]
        by_value = hasattr(camera, "_raygen_args")
        ci_alone = ci if by_value else torch.from_numpy(ci).to(dev)
        origin, dirs = camera.generate_rays_device(ci_alone, W, H, dev)
        origin_np, dirs_np = camera.generate_rays_device(ci, W, H, dev)
        digest.update(k3=_digest(dirs, origin), k3_numpy=_digest(dirs_np, origin_np))
        extra["by_value"] = by_value
        timed["k3"] = lambda: device_ms(
            lambda: camera.generate_rays_device(ci_alone, W, H, dev), K3_REPS)
        timed["k3_render"] = lambda: cuda_ms(
            lambda: camera.generate_rays_device(ci, W, H, dev), K3_REPS, 5)
    if "k5" in chosen or "k4" in chosen:
        words, res, shadow, counts = _frame(dev)
        digest["frame"] = _digest(*res, shadow, counts)
        extra["hits"] = int(res.hit.sum())
    if "k5" in chosen:
        from octree_tracer_tpu_torch.adaptive import feedback

        n_words = words.shape[0]
        for name, (sub_cap, unsub_cap, offset) in K5_CASES.items():
            args = (words, counts, n_words, sub_cap, unsub_cap, offset)
            digest[name] = _digest(feedback.select_candidates_packed(*args))
            timed[name] = (lambda a: lambda: device_ms(
                lambda: feedback.select_candidates_packed(*a), K45_REPS))(args)
    if "k4" in chosen:
        from octree_tracer_tpu_torch.render import tracer

        for name, u8 in (("k4_u8", True), ("k4_f32", False)):
            digest[name] = _digest(tracer.shade(res, shadow, u8=u8))
            timed[name] = (lambda u: lambda: device_ms(
                lambda: tracer.shade(res, shadow, u8=u), K45_REPS))(u8)
    if "k2" in chosen:
        from octree_tracer_tpu_torch import scenes, state
        from octree_tracer_tpu_torch.gen.procedural import Procedural
        from octree_tracer_tpu_torch.render import tracer

        chunk = Procedural(GEN_DEPTH, device=dev).generate_chunk(
            np.array(CORNERS[0], np.float32), WORLD_DEPTH)
        pools = {"k2": state.u32_to_device(scenes.deep_shell(DEPTH), dev),
                 "k2_chunk": state.u32_to_device(chunk.to_words(), dev)}
        del chunk
        for name, words in pools.items():
            digest[name] = _digest(*tracer.warp_occupancy(words, LEVELS))
            timed[name] = (lambda w: lambda: device_ms(
                lambda: tracer.warp_occupancy(w, LEVELS), K2_REPS))(words)
        digest["k2_levels"] = _digest(*(t for lv in range(10)
                                        for t in tracer.warp_occupancy(pools["k2"], lv)))
        extra["k2_pool_words"] = {k: int(w.shape[0]) for k, w in pools.items()}
        if hasattr(tracer, "k2_bytes"):
            extra["k2_bytes"] = {k: tracer.k2_bytes(w, LEVELS) for k, w in pools.items()}
        timed["k2_l1"] = lambda: device_ms(lambda: tracer.warp_occupancy(pools["k2"], 1),
                                           K2_REPS)
        fill = torch.empty(5 * 8 ** LEVELS, dtype=torch.uint8, device=dev)
        timed["k2_fill"] = lambda: device_ms(lambda: fill.fill_(1), K2_REPS)
    torch.cuda.synchronize()
    files = [SOURCES[k] for k in chosen]
    ptxas = [line for line in log.splitlines()
             if any(f in line for f in files) or "registers" in line or "spill" in line]
    ready = {"ready": True, "digest": digest, "ptxas": ptxas, **extra}
    return ready, lambda request: {k: fn() for k, fn in timed.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--kernels", default="k7,k3,k5,k4,k2",
                    help="comma-separated subset of k7, k3, k5, k4, k2")
    ap.add_argument("--unchecked", nargs="*", default=[],
                    help="trees whose outputs may differ (timing-only copies)")
    ap.add_argument("--out", default="_chip/kernel_steps")
    args = ap.parse_args(argv)
    chosen = args.kernels.split(",")
    if not chosen or any(k not in METRICS for k in chosen):
        ap.error(f"--kernels takes a subset of {','.join(METRICS)}")
    metrics = [m for k in chosen for m in METRICS[k]]

    import torch
    from octree_tracer_tpu_torch import kernels

    from . import trees

    if not torch.cuda.is_available():
        print("kernel_steps: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    names = [os.path.basename(os.path.normpath(t)) for t in args.trees]
    ready, replies = trees.run(args.trees, __file__, (",".join(chosen),), ("measure",),
                               args.rounds)
    samples = {name: {m: [rep[m] for rep in replies["measure"][i]] for m in metrics}
               for i, name in enumerate(names)}
    unchecked = {os.path.basename(os.path.normpath(t)) for t in args.unchecked}

    equal = True
    device = trees.card()
    print(f"{device}; {len(names)} trees, {args.rounds} rounds, ms per call (median, "
          f"[min, max])")
    for name, rd in zip(names, ready):
        differ = sorted(k for k, v in rd["digest"].items() if v != ready[0]["digest"].get(k))
        if name not in unchecked:
            equal = equal and not differ
        regs = [f"{r[0]}:{r[1]}r/{r[2]}+{r[3]}s"
                for r in kernels.register_report("\n".join(rd["ptxas"]))
                if any(SOURCES[k] in r[0] for k in chosen)]
        notes = [f"K3 alone from {'NumPy by value' if rd['by_value'] else 'a CUDA tensor'}"
                 ] if "by_value" in rd else []
        notes += [f"{rd['hits']} primary hits"] if "hits" in rd else []
        notes += [f"K2 pools {rd['k2_pool_words']} words"] if "k2_pool_words" in rd else []
        notes += [f"K2 bytes {rd['k2_bytes']}"] if "k2_bytes" in rd else []
        same = f"equal to {names[0]}'s" if not differ else f"DIFFER on {differ}"
        if name in unchecked:
            same += " (unchecked)"
        print(f"[{name}] outputs {same}: {rd['digest']}; "
              f"{'; '.join(notes + [f'registers {regs}'])}")
    for m in metrics:
        cells = []
        for name in names:
            v = samples[name][m]
            cells.append(f"{name} {float(np.median(v)):.5f} [{min(v):.5f}, {max(v):.5f}]")
        print(f"{m}: " + "; ".join(cells))
    with open(os.path.join(args.out, "kernel_steps.json"), "w") as f:
        json.dump({"device": device, "trees": names, "samples": samples, "ready": ready}, f)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
