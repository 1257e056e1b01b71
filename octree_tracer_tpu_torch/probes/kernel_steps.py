"""K7 and K3 across source trees: the island SDF grid and ray generation of
several versions of the port, timed in turn on one card.

    python -m octree_tracer_tpu_torch.probes.kernel_steps TREE [TREE ...] \\
        [--rounds R] [--out DIR]

Each TREE is a directory holding an ``octree_tracer_tpu_torch`` package: a
``git archive`` of an earlier commit, or a copy of this tree with one change.
Each tree's worker (see ``probes/trees.py``) builds its kernels, generates
the 8 chunk grids of the CLI's default world (chunk_depth 9, world_depth 1;
the first is the production chunk at (-1, -1, -1)) with its K7 and the
bench camera's 1920x1080 rays with its K3, and hashes all of them; the
workers then measure in turn, A B B A on the same card. The trees need only
the port's public API (``procedural.block_grid_packed``,
``camera.generate_rays_device``, ``gather_probe.cuda_ms``).

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
  in a tree that copies the matrix to the card, the copy and its wait.

Every tree must give the first tree's grids, directions and origin bit for
bit; the probe exits 1 if one does not. It prints the median and range over
rounds and each tree's K7 and K3 registers and spills, and writes all
samples to ``DIR/kernel_steps.json``.
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
K7_REPS, K3_REPS = 5, 50
METRICS = ("k7", "k7_world", "k3", "k3_render")


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


def setup():
    """In a worker: build the tree's kernels, make and hash its grids and
    rays; each request measures them."""
    import torch
    from octree_tracer_tpu_torch import kernels
    from octree_tracer_tpu_torch.gen import procedural
    from octree_tracer_tpu_torch.probes.gather_probe import cuda_ms as device_ms
    from octree_tracer_tpu_torch.render import camera

    dev = torch.device("cuda", 0)
    _, log = kernels.build()
    kernels.library()
    grids = [procedural.block_grid_packed(c, GEN_DEPTH, WORLD_DEPTH, dev) for c in CORNERS]
    ci = camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)[1]
    by_value = hasattr(camera, "_raygen_args")
    ci_alone = ci if by_value else torch.from_numpy(ci).to(dev)
    origin, dirs = camera.generate_rays_device(ci_alone, W, H, dev)
    origin_np, dirs_np = camera.generate_rays_device(ci, W, H, dev)
    torch.cuda.synchronize()
    digest = {"k7_production": _digest(grids[0]), "k7_world": _digest(*grids),
              "k3": _digest(dirs, origin), "k3_numpy": _digest(dirs_np, origin_np)}
    del grids

    def world():
        for c in CORNERS:
            procedural.block_grid_packed(c, GEN_DEPTH, WORLD_DEPTH, dev)

    timed = {
        "k7": lambda: cuda_ms(
            lambda: procedural.block_grid_packed(CORNERS[0], GEN_DEPTH, WORLD_DEPTH, dev),
            K7_REPS, 1),
        "k7_world": lambda: cuda_ms(world, 1, 1) / len(CORNERS),
        "k3": lambda: device_ms(lambda: camera.generate_rays_device(ci_alone, W, H, dev),
                                K3_REPS),
        "k3_render": lambda: cuda_ms(lambda: camera.generate_rays_device(ci, W, H, dev),
                                     K3_REPS, 5),
    }
    ptxas = [line for line in log.splitlines()
             if "block_grid" in line or "raygen" in line or "registers" in line
             or "spill" in line]
    ready = {"ready": True, "digest": digest, "by_value": by_value, "ptxas": ptxas}
    return ready, lambda request: {k: fn() for k, fn in timed.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default="_chip/kernel_steps")
    args = ap.parse_args(argv)

    import torch
    from octree_tracer_tpu_torch import kernels

    from . import trees

    if not torch.cuda.is_available():
        print("kernel_steps: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    names = [os.path.basename(os.path.normpath(t)) for t in args.trees]
    ready, replies = trees.run(args.trees, __file__, (), ("measure",), args.rounds)
    samples = {name: {m: [rep[m] for rep in replies["measure"][i]] for m in METRICS}
               for i, name in enumerate(names)}

    equal = True
    device = trees.card()
    print(f"{device}; {len(names)} trees, {args.rounds} rounds, ms per call (median, "
          f"[min, max])")
    for name, rd in zip(names, ready):
        same = rd["digest"] == ready[0]["digest"]
        equal = equal and same
        regs = [f"{r[0]}:{r[1]}r/{r[2]}+{r[3]}s"
                for r in kernels.register_report("\n".join(rd["ptxas"]))
                if "block_grid" in r[0] or "raygen" in r[0]]
        print(f"[{name}] grids, dirs and origin {'equal to' if same else 'DIFFER from'} "
              f"{names[0]}'s {rd['digest']}; K3 alone from "
              f"{'NumPy by value' if rd['by_value'] else 'a CUDA tensor'}; registers {regs}")
    for m in METRICS:
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
