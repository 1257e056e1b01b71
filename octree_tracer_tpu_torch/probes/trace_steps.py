"""K1 across source trees: the traversal passes of several versions of the
port, timed in turn on one card.

    python -m octree_tracer_tpu_torch.probes.trace_steps TREE [TREE ...] \\
        [--rounds R] [--unchecked TREE ...] [--out DIR]

Each TREE is a directory holding an ``octree_tracer_tpu_torch`` package: a
``git archive`` of an earlier commit, or a copy of this tree with one change.
Each tree's worker (see ``probes/trees.py``) builds its kernels and sets up
two scenes at 1920x1080: deep10 with the combined level-7 table from the
bench camera, and the generated island terrain (``scenes.terrain(9)``, a
512^3 chunk) from ``scenes.TERRAIN_CAMERA``; the workers then measure in
turn, A B B A on the same card. The trees need only the port's public API
(``render_frame``, ``trace``, ``trace_shadow``, ``build_bricks``,
``skip.build_warp_skip_table``). For the combined-table frame each worker
runs ``render_frame`` once per frame kind with its ``trace`` and
``trace_shadow`` wrapped and replays the launches it recorded, so every
tree is timed on the calls its own frame makes.

Per tree and round, from CUDA events (mean of 10 calls after 2 warm-ups),
ms a call (``METRICS``):

- the combined-table frame: ``primary`` and ``shadow`` (its two K1
  launches), ``counts`` and ``shadow_counts`` (a frame counting visits),
  ``flags`` (the primary launch of a frame marking flags), and the whole u8
  frame with and without shadows (``frame_sh``, ``frame_pr``);
- K1's root form (``parent_restart=False``) on deep10's primaries, without a
  table (``root_none*``) and with the combined table (``root_comb*``):
  unmarked, counts, flags, and the shadow mode's counts;
- on each scene (``deep10_*``, ``terrain_*``): the no-table primary pass and
  shadow mode, the combined-table primary, and the brick forms
  (``bricks.build_bricks``'s table): the primary at brick_k 1, 4 and 8, the
  shadow mode, and the counted primary in both restart forms (brick_k 4).

Every tree must give the first tree's results bit for bit (the frame's
image and result, every pass's result, shadow hits and visit arrays,
hashed), except the trees named by ``--unchecked`` (timing copies whose
outputs may differ); the probe exits 1 if one does not. Each worker also
reports the root form's marks by the depth of the marked slot
(``tracer.slot_depths`` of the pool) and its largest slot count. The probe
prints the median and range over rounds and each tree's K1 registers and
spills, writes all samples to ``DIR/trace_steps.json`` and, where
``cuobjdump`` is found, each tree's SASS of the strict unmarked primary
instantiations with the combined table and with bricks to
``DIR/sass_<tree>.txt``.
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
TERRAIN_DEPTH = 9
LEVELS = 7
CAM_POS = np.array([0.2, 0.3, -2.4], np.float32)  # bench.py:255-257
CAM_LOOK = np.array([-0.1, -0.15, 1.0], np.float32)
FOV = 70.0
REPS, WARMUP = 10, 2
SCENES = ("deep10", "terrain")
SCENE_METRICS = ("no_table", "no_table_shadow", "combined", "bricks_k1", "bricks_k4",
                 "bricks_k8", "bricks_shadow", "bricks_counts", "bricks_root_counts")
METRICS = ("primary", "shadow", "counts", "shadow_counts", "flags", "frame_sh", "frame_pr",
           *(f"root_{t}{m}" for t in ("none", "comb")
             for m in ("", "_counts", "_flags", "_shadow_counts")),
           *(f"{s}_{m}" for s in SCENES for m in SCENE_METRICS))
# The instantiations whose SASS is written: strict, unmarked primaries with
# the combined table, and with bricks (root-restart and brick flags last).
SASS_FORMS = (r"trace_kernelILb1ELi2ELi0ELb0E(Lb0E)?(Lb0E)?E",
              r"trace_kernelILb1ELi0ELi0ELb0ELb0ELb1EE")


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


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes, in
    order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def marks_by_depth(counts, depths) -> list[int]:
    """The marks of ``counts`` (int32[pool] visit counts) summed by the
    depth of their slot (``depths``, ``tracer.slot_depths``; slots no descent
    reaches are left out), from depth 0 down."""
    import torch

    d = torch.as_tensor(depths, device=counts.device).long()
    keep = d >= 0
    if not bool(keep.any()):
        return []
    sums = torch.bincount(d[keep], weights=counts[keep].double())
    return [int(x) for x in sums.cpu()]


def setup(data_dir: str):
    """In a worker: set up the tree's passes; each request measures them."""
    import torch
    from octree_tracer_tpu_torch import kernels, state
    from octree_tracer_tpu_torch.render import bricks, camera, skip, tracer

    dev = torch.device("cuda", 0)
    lib_path, log = kernels.build()
    kernels.library()
    words = state.u32_to_device(np.load(os.path.join(data_dir, "words.npy")), dev)
    ci = np.load(os.path.join(data_dir, "ci.npy"))
    table = skip.build_warp_skip_table(words, LEVELS)
    origin, dirs = camera.generate_rays_device(ci, W, H, dev)
    origins = origin.expand(W * H, 3)

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
    digests = {"frame": digest(img, *res), "shadow": digest(sh),
               "counts": digest(sh_c, counts), "flags": digest(flags)}
    timed = {"primary": plain_calls[0], "shadow": plain_calls[1],
             "counts": count_calls[0], "shadow_counts": count_calls[1],
             "flags": flag_calls[0], "frame_sh": lambda: frame(True),
             "frame_pr": lambda: frame(False)}

    def zeros(w):
        return torch.zeros(w.shape[0], dtype=torch.int32, device=dev)

    # The root form on deep10's primaries, without a table and with it.
    depths = np.load(os.path.join(data_dir, "depths.npy"))
    buf = zeros(words)
    marks = {}
    for what, t in (("none", None), ("comb", table)):
        kw = dict(warp_table=t, parent_restart=False)
        r = tracer.trace(words, origins, dirs, **kw)
        v_c, v_f, v_s = zeros(words), zeros(words), zeros(words)
        tracer.trace(words, origins, dirs, visits=v_c, **kw)
        tracer.trace(words, origins, dirs, visits=v_f, visit_flags=True, **kw)
        tracer.trace_shadow(words, r, cull=False, visits=v_s, image_width=W, **kw)
        digests[f"root_{what}"] = digest(*r, v_c, v_f, v_s)
        marks[what] = {"by_depth": marks_by_depth(v_c, depths), "total": int(v_c.sum()),
                       "largest_slot": int(v_c.max()),
                       "shadow_by_depth": marks_by_depth(v_s, depths)}
        timed.update({
            f"root_{what}": lambda kw=kw: tracer.trace(words, origins, dirs, **kw),
            f"root_{what}_counts": lambda kw=kw: tracer.trace(words, origins, dirs,
                                                              visits=buf, **kw),
            f"root_{what}_flags": lambda kw=kw: tracer.trace(words, origins, dirs, visits=buf,
                                                             visit_flags=True, **kw),
            f"root_{what}_shadow_counts": lambda kw=kw, r=r: tracer.trace_shadow(
                words, r, cull=False, visits=buf, image_width=W, **kw)})

    # Each scene without a table, with the combined table and with bricks.
    for scene in SCENES:
        if scene == "deep10":
            w, s_origins, s_dirs, s_table = words, origins, dirs, table
        else:
            w = state.u32_to_device(np.load(os.path.join(data_dir, "terrain.npy")), dev)
            o, s_dirs = camera.generate_rays_device(
                np.load(os.path.join(data_dir, "terrain_ci.npy")), W, H, dev)
            s_origins = o.expand(W * H, 3)
            s_table = skip.build_warp_skip_table(w, LEVELS)
        dec, br = bricks.build_bricks(w)
        base = tracer.trace(w, s_origins, s_dirs)
        rb = tracer.trace(dec, s_origins, s_dirs, bricks=br)
        v_b, v_r = zeros(w), zeros(w)
        tracer.trace(dec, s_origins, s_dirs, bricks=br, visits=v_b)
        tracer.trace(dec, s_origins, s_dirs, bricks=br, visits=v_r, parent_restart=False)
        digests[scene] = digest(*base, *rb, v_b, v_r,
                                tracer.trace_shadow(w, base, image_width=W),
                                tracer.trace_shadow(dec, rb, bricks=br, image_width=W),
                                *tracer.trace(w, s_origins, s_dirs, warp_table=s_table))
        s_buf = zeros(w)
        g = dict(w=w, o=s_origins, d=s_dirs, t=s_table, dec=dec, br=br, base=base, rb=rb,
                 v=s_buf)
        timed.update({
            f"{scene}_no_table": lambda g=g: tracer.trace(g["w"], g["o"], g["d"]),
            f"{scene}_no_table_shadow": lambda g=g: tracer.trace_shadow(
                g["w"], g["base"], image_width=W),
            f"{scene}_combined": lambda g=g: tracer.trace(g["w"], g["o"], g["d"],
                                                          warp_table=g["t"]),
            **{f"{scene}_bricks_k{k}": lambda g=g, k=k: tracer.trace(
                g["dec"], g["o"], g["d"], bricks=g["br"], brick_k=k) for k in (1, 4, 8)},
            f"{scene}_bricks_shadow": lambda g=g: tracer.trace_shadow(
                g["dec"], g["rb"], bricks=g["br"], image_width=W),
            f"{scene}_bricks_counts": lambda g=g: tracer.trace(
                g["dec"], g["o"], g["d"], bricks=g["br"], visits=g["v"]),
            f"{scene}_bricks_root_counts": lambda g=g: tracer.trace(
                g["dec"], g["o"], g["d"], bricks=g["br"], visits=g["v"],
                parent_restart=False)})
    torch.cuda.synchronize()
    ptxas = [line for line in log.splitlines()
             if "trace_kernel" in line or "registers" in line or "spill" in line]
    ready = {"ready": True, "digest": digests, "library": lib_path,
             "hits": int(res.hit.sum()), "root_marks": marks, "ptxas": ptxas}
    return ready, lambda request: {k: cuda_ms(fn) for k, fn in timed.items()}


def form_name(mangled: str) -> str:
    """A K1 instantiation's flags from its mangled name, as
    ``s<strict>t<table>v<visits>h<shadow>r<root>b<bricks>`` (a tree from
    before the root or brick forms names them without the last flags)."""
    m = re.search(r"trace_kernelI((?:L[bi]\d+E)+)E", mangled)
    if not m:
        return mangled
    flags = re.findall(r"L[bi](\d+)E", m.group(1))
    return "".join(f"{k}{v}" for k, v in zip("stvhrb", flags))


def register_lines(ptxas: list[str]) -> tuple[dict, int]:
    """Registers and spill bytes of K1's root-form counting and brick
    instantiations, by ``form_name``, and the most registers any other K1
    instantiation takes."""
    from octree_tracer_tpu_torch import kernels

    shown, others = {}, 0
    for fn, regs, st, ld in kernels.register_report("\n".join(ptxas)):
        if "trace_kernel" not in fn:
            continue
        name = form_name(fn)
        root_counting = "r1" in name and "v0" not in name
        if root_counting or name.endswith("b1"):
            shown[name] = f"{regs}r/{st}+{ld}s"
        else:
            others = max(others, regs)
    return shown, others


def summary_lines(samples: dict, names: list[str]) -> list[str]:
    """One line a metric: each tree's median and [min, max] over rounds."""
    lines = []
    for m in METRICS:
        cells = []
        for name in names:
            v = samples[name][m]
            cells.append(f"{name} {float(np.median(v)):.4f} [{min(v):.4f}, {max(v):.4f}]")
        lines.append(f"{m}: " + "; ".join(cells))
    return lines


def _sass(lib: str, ptxas: list[str], out_path: str) -> bool:
    from octree_tracer_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    fns = [r[0] for r in kernels.register_report("\n".join(ptxas))]
    names = [next((f for f in fns if re.search(p, f)), None) for p in SASS_FORMS]
    names = [n for n in names if n]
    if not os.path.exists(tool) or not names:
        return False
    ok = True
    with open(out_path, "w") as f:
        for name in names:
            out = subprocess.run([tool, "-sass", "-fun", name, lib], capture_output=True,
                                 text=True)
            f.write(out.stdout + out.stderr)
            ok = ok and out.returncode == 0
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--unchecked", nargs="*", default=[],
                    help="trees timed whose results may differ from the first tree's")
    ap.add_argument("--out", default="_chip/trace_steps")
    args = ap.parse_args(argv)

    import torch
    from octree_tracer_tpu_torch import scenes
    from octree_tracer_tpu_torch.render import camera, tracer

    from . import trees

    if not torch.cuda.is_available():
        print("trace_steps: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    all_trees = list(args.trees) + list(args.unchecked)
    names = [os.path.basename(os.path.normpath(t)) for t in all_trees]
    checked = names[:len(args.trees)]
    data_dir = tempfile.mkdtemp(prefix="ot_trace_steps_")
    try:
        words = scenes.deep_shell(DEPTH)
        np.save(os.path.join(data_dir, "words.npy"), words)
        np.save(os.path.join(data_dir, "depths.npy"), tracer.slot_depths(words))
        np.save(os.path.join(data_dir, "ci.npy"),
                camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)[1])
        np.save(os.path.join(data_dir, "terrain.npy"), scenes.terrain(TERRAIN_DEPTH))
        pos, look, fov = scenes.TERRAIN_CAMERA
        np.save(os.path.join(data_dir, "terrain_ci.npy"),
                camera.camera_matrices(pos, look, fov, W, H)[1])
        ready, replies = trees.run(all_trees, __file__, (data_dir,), ("measure",),
                                   args.rounds)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    samples = {name: {m: [rep[m] for rep in replies["measure"][i]] for m in METRICS}
               for i, name in enumerate(names)}

    equal = True
    device = trees.card()
    print(f"{device}; {len(names)} trees ({len(checked)} checked), {args.rounds} rounds, "
          f"ms per call (median, [min, max])")
    for name, rd in zip(names, ready):
        differ = sorted(k for k, v in rd["digest"].items() if ready[0]["digest"].get(k) != v)
        if name in checked:
            equal = equal and not differ
        regs, others = register_lines(rd["ptxas"])
        sass = _sass(rd["library"], rd["ptxas"], os.path.join(args.out, f"sass_{name}.txt"))
        print(f"[{name}] results {'equal to' if not differ else f'DIFFER ({differ}) from'} "
              f"{names[0]}'s{'' if name in checked else ' (unchecked)'}; hits {rd['hits']}; "
              f"sass {'written' if sass else 'not found'}; root-form marks {rd['root_marks']}; "
              f"K1 registers {regs}, the other forms at most {others}")
    for line in summary_lines(samples, names):
        print(line)
    with open(os.path.join(args.out, "trace_steps.json"), "w") as f:
        json.dump({"device": device, "trees": names, "checked": checked, "samples": samples,
                   "ready": ready}, f)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
