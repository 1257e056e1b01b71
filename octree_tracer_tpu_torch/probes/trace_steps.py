"""K1 across source trees: the frame's traversal passes of several versions
of the port, timed in turn on one card.

    python -m octree_tracer_tpu_torch.probes.trace_steps TREE [TREE ...] \\
        [--rounds R] [--out DIR]

Each TREE is a directory holding an ``octree_tracer_tpu_torch`` package: a
``git archive`` of an earlier commit, or a copy of this tree with one change.
Each tree's worker (see ``probes/trees.py``) builds its kernels and sets up
the deep10 scene at 1920x1080 with the combined level-7 table and the bench
camera; the workers then measure in turn, A B B A on the same card. The
trees need only the port's public API (``render_frame``,
``trace``, ``skip.build_warp_skip_table``): each worker runs
``render_frame`` once per frame kind with its ``trace`` (and
``trace_shadow``, where the tree has it) wrapped, and replays the launches
it recorded, so every tree is timed on the calls its own frame makes.

Per tree and round, from CUDA events (mean of 10 calls after 2 warm-ups):
``primary`` and ``shadow`` (the two K1 launches of the shadowed frame),
``counts`` and ``shadow_counts`` (a frame counting visits), ``flags`` (the
primary launch of a frame marking flags), and the whole u8 frame with and
without shadows (``frame_sh``, ``frame_pr``). Every tree must give the
first tree's results bit for bit (image, primary result, shadow hits and
both visit arrays, hashed); the probe exits 1 if one does not. It prints
the median and range over rounds and each tree's K1 registers and spills,
writes all samples to ``DIR/trace_steps.json`` and each tree's SASS of the
primary K1 instantiation (strict, combined table, no visits) to
``DIR/sass_<tree>.txt`` where ``cuobjdump`` is found.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

W, H = 1920, 1080
DEPTH = 10
LEVELS = 7
CAM_POS = np.array([0.2, 0.3, -2.4], np.float32)  # bench.py:255-257
CAM_LOOK = np.array([-0.1, -0.15, 1.0], np.float32)
FOV = 70.0
REPS, WARMUP = 10, 2
METRICS = ("primary", "shadow", "counts", "shadow_counts", "flags", "frame_sh", "frame_pr")


def cuda_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
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


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def setup(data_dir: str):
    """In a worker: set up the tree's frame; each request measures it."""
    import torch
    from octree_tracer_tpu_torch import kernels, state
    from octree_tracer_tpu_torch.render import camera, skip, tracer

    dev = torch.device("cuda", 0)
    lib_path, log = kernels.build()
    kernels.library()
    words = state.u32_to_device(np.load(os.path.join(data_dir, "words.npy")), dev)
    ci = np.load(os.path.join(data_dir, "ci.npy"))
    table = skip.build_warp_skip_table(words, LEVELS)
    origin, dirs = camera.generate_rays_device(ci, W, H, dev)

    def frame(shadows=True, **kw):
        return tracer.render_frame(words, origin, dirs, shadows=shadows, warp_table=table,
                                   u8_image=True, **kw)

    def recorded(**kw):
        """The frame's K1 launches as replayable calls, and its outputs."""
        calls, outs = [], []
        originals = {name: getattr(tracer, name) for name in ("trace", "trace_shadow")
                     if hasattr(tracer, name)}

        def wrap(fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                calls.append(lambda: fn(*args, **kwargs))
                outs.append(out)
                return out
            return call

        for name, fn in originals.items():
            setattr(tracer, name, wrap(fn))
        try:
            img, res, visits = frame(**kw)
        finally:
            for name, fn in originals.items():
                setattr(tracer, name, fn)
        shadow = outs[1] if len(outs) > 1 else None
        shadow_hit = shadow if isinstance(shadow, torch.Tensor) else shadow.hit
        return calls, (img, res, shadow_hit, visits)

    plain_calls, (img, res, sh, _) = recorded()
    count_calls, (_, _, sh_c, counts) = recorded(with_visits=True)
    flag_calls, (_, _, _, flags) = recorded(with_visits=True, visit_flags=True)
    torch.cuda.synchronize()
    digest = {"frame": _digest(img, *res), "shadow": _digest(sh),
              "counts": _digest(sh_c, counts), "flags": _digest(flags)}
    timed = {"primary": plain_calls[0], "shadow": plain_calls[1],
             "counts": count_calls[0], "shadow_counts": count_calls[1],
             "flags": flag_calls[0], "frame_sh": lambda: frame(True),
             "frame_pr": lambda: frame(False)}
    ptxas = [line for line in log.splitlines()
             if "trace_kernel" in line or "registers" in line or "spill" in line]
    ready = {"ready": True, "digest": digest, "library": lib_path, "hits": int(res.hit.sum()),
             "ptxas": ptxas}
    return ready, lambda request: {k: cuda_ms(fn) for k, fn in timed.items()}


def _sass(lib: str, ptxas: list[str], out_path: str) -> bool:
    from octree_tracer_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    # The strict, combined-table, unmarked primary kernel, parent-restart
    # form (a tree from before the root form names it without the last flag).
    names = [r[0] for r in kernels.register_report("\n".join(ptxas))
             if re.search(r"trace_kernelILb1ELi2ELi0ELb0E(Lb0E)?E", r[0])]
    if not os.path.exists(tool) or not names:
        return False
    out = subprocess.run([tool, "-sass", "-fun", names[0], lib], capture_output=True,
                         text=True)
    with open(out_path, "w") as f:
        f.write(out.stdout + out.stderr)
    return out.returncode == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default="_chip/trace_steps")
    args = ap.parse_args(argv)

    import torch
    from octree_tracer_tpu_torch import kernels, scenes
    from octree_tracer_tpu_torch.render import camera

    from . import trees

    if not torch.cuda.is_available():
        print("trace_steps: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    names = [os.path.basename(os.path.normpath(t)) for t in args.trees]
    data_dir = tempfile.mkdtemp(prefix="ot_trace_steps_")
    try:
        np.save(os.path.join(data_dir, "words.npy"), scenes.deep_shell(DEPTH))
        np.save(os.path.join(data_dir, "ci.npy"),
                camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)[1])
        ready, replies = trees.run(args.trees, __file__, (data_dir,), ("measure",),
                                   args.rounds)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    samples = {name: {m: [rep[m] for rep in replies["measure"][i]] for m in METRICS}
               for i, name in enumerate(names)}

    equal = True
    device = trees.card()
    print(f"{device}; {len(names)} trees, {args.rounds} rounds, ms per call (median, "
          f"[min, max])")
    for name, rd in zip(names, ready):
        same = rd["digest"] == ready[0]["digest"]
        equal = equal and same
        regs = [f"{r[0].split('trace_kernel')[1][:24]}:{r[1]}r/{r[2]}+{r[3]}s"
                for r in kernels.register_report("\n".join(rd["ptxas"]))
                if "trace_kernel" in r[0]]
        sass = _sass(rd["library"], rd["ptxas"], os.path.join(args.out, f"sass_{name}.txt"))
        print(f"[{name}] results {'equal to' if same else 'DIFFER from'} {names[0]}'s "
              f"{rd['digest']}; hits {rd['hits']}; sass {'written' if sass else 'not found'}; "
              f"K1 registers {regs}")
    for m in METRICS:
        cells = []
        for name in names:
            v = samples[name][m]
            cells.append(f"{name} {float(np.median(v)):.4f} [{min(v):.4f}, {max(v):.4f}]")
        print(f"{m}: " + "; ".join(cells))
    with open(os.path.join(args.out, "trace_steps.json"), "w") as f:
        json.dump({"device": device, "trees": names, "samples": samples, "ready": ready}, f)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
