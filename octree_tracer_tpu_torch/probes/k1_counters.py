"""K1's event counters: an instrumented copy of ``csrc/trace.cu`` that counts
what a pass does, for measurements the timed kernel cannot report.

The copy is the source text with four insertions (``instrumented_source``):
a device array of counters, a count of every visit atomic the kernel issues
(into the visit array: a lane's mark, a block's flush of its top-of-tree
entries; and into shared memory: a top-of-tree mark), and at the
top of every loop trip of the brick forms a count of the warp-trip (its
lanes as ``__activemask`` finds them executing together), whether those
lanes split between brick trips and descents, and the lane-trips of each
mode. ``build`` compiles it alone into a shared library (one ``nvcc``, as
``kernels.build`` compiles one source); ``Counting(path)`` swaps it in for
the port's library while a ``with`` block runs, so ``tracer.trace`` and
``tracer.trace_shadow`` launch the instrumented kernel, and ``read()``
returns the counts since the last read. The counters add atomics of their
own, so a counted pass is never timed. Launches inside the block are not
counted in ``kernels.LAUNCHES``' sense of a main path: callers reset the
counts after it.

    python -m octree_tracer_tpu_torch.probes.k1_counters [TREE] [--out DIR]

counts K1's passes on the deep10 and terrain frames of ``trace_steps``
(without ``TREE``, this tree's kernel) and writes ``DIR/k1_counters.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile


FIELDS = ("warp_trips", "split_warp_trips", "brick_lane_trips", "descent_lane_trips",
          "atomics", "shared_atomics")

_COUNTERS = """
__device__ unsigned long long g_k1_counters[8];

__device__ __forceinline__ int k1_count_atomic() {
  atomicAdd(&g_k1_counters[4], 1ull);
  return 0;
}

__device__ __forceinline__ int k1_count_shared() {
  atomicAdd(&g_k1_counters[5], 1ull);
  return 0;
}
"""

_TRIP = """      if (BRICKS) {
        const unsigned k1_act = __activemask();
        const unsigned k1_bm = __ballot_sync(k1_act, bmode);
        if ((threadIdx.x & 31) == __ffs(k1_act) - 1) {
          atomicAdd(&g_k1_counters[0], 1ull);
          if (k1_bm != 0u && k1_bm != k1_act) atomicAdd(&g_k1_counters[1], 1ull);
          atomicAdd(&g_k1_counters[2], static_cast<unsigned long long>(__popc(k1_bm)));
          atomicAdd(&g_k1_counters[3],
                    static_cast<unsigned long long>(__popc(k1_act & ~k1_bm)));
        }
      }
"""

_READ = """
extern "C" int ot_k1_counters(void* out, int reset) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_k1_counters, sizeof(g_k1_counters));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(g_k1_counters, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
"""

_INCLUDE = '#include "common.cuh"\n'
_LOOP = "    for (int it = 0; it < a.max_iters; ++it) {\n"
# The kernel's atomics into the visit array (a lane's mark, a block's
# flush of its top-of-tree entries) and into shared memory (a top mark).
_ATOMIC = re.compile(r"atomicAdd\((a\.)?visits \+ ")
_SHARED = "atomicAdd(top.count + "


def instrumented_source(src: str) -> str:
    """``trace.cu``'s text with the counters inserted; raises if an anchor
    is missing (the include and the trip loop exactly once, at least one
    visit atomic)."""
    if src.count(_INCLUDE) != 1 or src.count(_LOOP) != 1 or not _ATOMIC.search(src):
        raise ValueError("trace.cu no longer holds the anchors the counters patch")
    src = src.replace(_INCLUDE, _INCLUDE + _COUNTERS)
    src = src.replace(_LOOP, _LOOP + _TRIP)
    src = _ATOMIC.sub(lambda m: "k1_count_atomic(), " + m.group(0), src)
    src = src.replace(_SHARED, "k1_count_shared(), " + _SHARED)
    return src + _READ


def start_build(tree: str, out_dir: str) -> tuple[subprocess.Popen, str]:
    """Start compiling the instrumented copy of ``tree``'s ``trace.cu`` (a
    directory holding ``octree_tracer_tpu_torch``) into ``out_dir``; returns
    the ``nvcc`` process and the library's path. ``finish_build`` waits."""
    from octree_tracer_tpu_torch import kernels

    csrc = os.path.join(tree, "octree_tracer_tpu_torch", "csrc")
    with open(os.path.join(csrc, "trace.cu")) as f:
        src = instrumented_source(f.read())
    os.makedirs(out_dir, exist_ok=True)
    unit = os.path.join(out_dir, "trace_counted.cu")
    with open(unit, "w") as f:
        f.write(src)
    path = os.path.join(out_dir, "libot_trace_counted.so")
    proc = subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, f"-I{csrc}", "-shared",
                             "-o", path, unit], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, path


def finish_build(proc: subprocess.Popen, path: str) -> str:
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the counted trace.cu:\n{out}")
    return path


class Counting:
    """``with Counting(path) as c:`` K1's launches go to the instrumented
    library at ``path``, which holds K1 alone (no other kernel may run in
    the block); ``c.read()`` returns the counts since the last read as a
    dict of ``FIELDS``."""

    def __init__(self, path: str):
        from octree_tracer_tpu_torch import kernels

        lib = ctypes.CDLL(path)
        for name in ("ot_trace", "ot_trace_shadow"):
            getattr(lib, name).argtypes = kernels._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        lib.ot_k1_counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ot_k1_counters.restype = ctypes.c_int
        self.lib = lib
        self._saved = None

    def read(self) -> dict:
        buf = (ctypes.c_ulonglong * 8)()
        rc = self.lib.ot_k1_counters(ctypes.addressof(buf), 1)
        if rc != 0:
            raise RuntimeError(f"reading K1's counters failed: CUDA error {rc}")
        return dict(zip(FIELDS, (int(x) for x in buf)))

    def __enter__(self):
        from octree_tracer_tpu_torch import kernels

        kernels.library()
        self._saved = kernels._lib
        kernels._lib = self.lib
        self.read()
        return self

    def __exit__(self, *exc):
        from octree_tracer_tpu_torch import kernels

        kernels._lib = self._saved
        return False


def split_share(counts: dict) -> float:
    """The share of the brick forms' warp-trips whose lanes split."""
    return counts["split_warp_trips"] / max(counts["warp_trips"], 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=None)
    ap.add_argument("--out", default="_chip/k1_counters")
    args = ap.parse_args(argv)

    import torch
    from octree_tracer_tpu_torch import scenes, state
    from octree_tracer_tpu_torch.render import bricks, camera, skip, tracer

    from . import trace_steps as ts
    from . import trees

    if not torch.cuda.is_available():
        print("k1_counters: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(args.tree or here)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="ot_k1_counters_") as tmp:
        path = finish_build(*start_build(tree, tmp))
        frames = {"deep10": (scenes.deep_shell(ts.DEPTH), (ts.CAM_POS, ts.CAM_LOOK, ts.FOV)),
                  "terrain": (scenes.terrain(ts.TERRAIN_DEPTH), scenes.TERRAIN_CAMERA)}
        out = {"device": trees.card(), "tree": tree}
        counting = Counting(path)
        for name, (words_np, (pos, look, fov)) in frames.items():
            # The inputs first: only K1 runs while the counted library is in.
            w = state.u32_to_device(words_np, dev)
            _, ci = camera.camera_matrices(pos, look, fov, ts.W, ts.H)
            o, d = camera.generate_rays_device(ci, ts.W, ts.H, dev)
            o = o.expand(ts.W * ts.H, 3)
            dec, br = bricks.build_bricks(w)
            table = skip.build_warp_skip_table(w, ts.LEVELS)
            v = torch.zeros(w.shape[0], dtype=torch.int32, device=dev)
            res = {}
            with counting as c:
                for what, t in (("none", None), ("combined", table)):
                    for restart in (True, False):
                        form = "parent" if restart else "root"
                        v.zero_()
                        c.read()
                        r = tracer.trace(w, o, d, visits=v, warp_table=t,
                                         parent_restart=restart)
                        res[f"{form}_{what}_counts"] = dict(c.read(), marks=int(v.sum()))
                        v.zero_()
                        tracer.trace_shadow(w, r, cull=False, visits=v, warp_table=t,
                                            parent_restart=restart, image_width=ts.W)
                        res[f"{form}_{what}_shadow_counts"] = dict(c.read(),
                                                                   marks=int(v.sum()))
                for k in (1, 4, 8):
                    for restart in (True, False):
                        form = "parent" if restart else "root"
                        tracer.trace(dec, o, d, bricks=br, brick_k=k, parent_restart=restart)
                        cnt = c.read()
                        res[f"bricks_k{k}_{form}"] = dict(cnt, split_share=split_share(cnt))
                rb = tracer.trace(dec, o, d, bricks=br)
                c.read()
                tracer.trace_shadow(dec, rb, bricks=br, image_width=ts.W)
                cnt = c.read()
                res["bricks_shadow_k4"] = dict(cnt, split_share=split_share(cnt))
            out[name] = res
            print(f"{name}: {json.dumps(res)}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "k1_counters.json"), "w") as f:
        json.dump(out, f)
    print(out["device"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
