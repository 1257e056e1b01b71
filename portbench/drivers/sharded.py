"""Frames of a static scene with their rows sharded over ranks, one card a
rank: the program's ``render_frame_sharded`` (K3 on the whole frame, K1
primary, K1 shadow mode and K4 on the rank's block of rows, then the
frame's two all-gathers), each frame waiting for the one before, as the
``orbit`` driver's frames do. Poses cycle through the same seeded orbit.

The harness process is rank 0, on the device the harness gives it; ranks
1 and up are spawned processes (``HELPER``), rank r on ``cuda:r``, or CPU
processes when the harness runs on the CPU. The world size is the cell's
``chips``, the backend ``parallel.launch.backend_for``'s. Rank 0 builds
the pool and ``mesh.replicate`` hands it to the others; each rank builds
the table and generates the whole frame's rays itself, as
``ShardedSession`` does. Every rank runs the same frames: after every
``flag_every`` frames rank 0 broadcasts one int32 that says whether the
window goes on, and whether the profiled stretch follows, in which every
rank profiles the same frames.

After the window each rank reports its memory peak, its last frame, its
traced stretch and the modules it loaded, and ends. A rank that fails ends
the run with its traceback; a rank whose parent dies is killed with it.

Checked on rank 0 once the ranks have ended: its gathered frames at a few
seeded indices and the last one, every pixel (hit, the hit leaf's slot,
the u8 colour) against the reference's frame of the same pool from the
same pose (``frame_diff_pct``); and the pixels of the last frame whose
colour, hit or slot on any other rank differs from rank 0's
(``rank_frame_off``: the gather is a copy)."""

from __future__ import annotations

import ctypes
import datetime
import faulthandler
import math
import multiprocessing as mp
import os
import queue
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import compare, harness, readers, scenes, traffic, yardstick
from ..reference import trace as ref_trace
from . import Base

# Rank 0's flag after every ``flag_every`` frames.
GO, STOP, TRACE = 1, 0, 2
# Seconds a collective may wait.
TIMEOUT_S = 300.0
# Seconds the other ranks may take to report once rank 0's frames are done:
# they run the same frames in step with it.
REPORT_S = 120.0
# Seconds rank 0 may stay stuck after a rank died before the run ends from
# the watchdog: NCCL's collectives wait on a dead peer until their timeout.
HANG_S = 30.0


class Frames:
    """What every rank holds and does: the mesh, the replicated pool and
    the table, the poses' camera matrices, one frame, the window's flags,
    the traced stretch. ``store`` is the file of the run's process group."""

    def __init__(self, spec: dict, seed: int, mesh, store: str,
                 words_np: np.ndarray | None = None):
        from octree_tracer_tpu_torch.parallel import mesh as pmesh
        from octree_tracer_tpu_torch.render import camera, skip
        from octree_tracer_tpu_torch.state import u32_to_device

        s, t = spec["settings"], spec["traffic"]
        self.settings, self.traffic, self.mesh = s, t, mesh
        self.meeting = dist.FileStore(store + ".meet", mesh.size)
        words = None if words_np is None else u32_to_device(words_np, mesh.device)
        self.words = pmesh.replicate(mesh, words)
        self.table = skip.build_warp_skip_table(self.words, s["warp_levels"])
        self.poses = traffic.orbit_poses(seed, t)
        self.cis = [camera.camera_matrices(p, look, s["fov"], s["width"], s["height"])[1]
                    for p, look in self.poses]
        self.sun = np.asarray(s["sun"], np.float32)

    def frame(self, i: int):
        """Frame i on this rank: (u8 image, TraceResult) of the whole
        frame."""
        from octree_tracer_tpu_torch.parallel import mesh as pmesh
        from octree_tracer_tpu_torch.render import camera

        s = self.settings
        origin, dirs = camera.generate_rays_device(self.cis[i % len(self.cis)], s["width"],
                                                   s["height"], self.mesh.device)
        img, res, _ = pmesh.render_frame_sharded(self.mesh, self.words, origin, dirs,
                                                 sun_dir=self.sun, shadows=s["shadows"],
                                                 warp_table=self.table, u8_image=s["u8"])
        return img, res

    def sync(self) -> None:
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    def flag(self, value: int = GO) -> int:
        """Rank 0's ``value`` on every rank."""
        t = torch.full((1,), value, dtype=torch.int32, device=self.mesh.device)
        dist.broadcast(t, self.mesh.src, group=self.mesh.group)
        return value if self.mesh.rank == 0 else int(t.item())

    def warm(self) -> None:
        for i in range(self.traffic["warm_frames"]):
            self.frame(i)
        self.sync()

    def stop(self, when_due: int = STOP):
        """The ``Window.run`` stop of every rank: after every
        ``flag_every`` frames rank 0's flag, GO before the deadline and
        ``when_due`` after it, reaches every rank, and the window ends
        where it is not GO. The last flag is kept in ``last_flag``."""
        every = self.traffic["flag_every"]

        def stop(i: int, due: bool) -> bool:
            if (i + 1) % every:
                return False
            self.last_flag = self.flag(when_due if due else GO)
            return self.last_flag != GO
        return stop

    def profile(self) -> dict:
        """The traced stretch: ``profile_ops`` frames under the profiler.
        The ranks start it together, once every rank's profiler is on: a
        profiler that starts late would hold the others spinning in their
        first gather."""
        def traced(i):
            with torch.profiler.record_function("frame"):
                self.frame(i)
                self.sync()
        return yardstick.profile(traced, self.traffic["profile_ops"], self.sync, ("frame",),
                                 start=self.meet)

    def meet(self) -> None:
        """Wait until every rank is here, on the host alone: no collective,
        whose kernel would spin on the card."""
        self.meeting.add("traced", 1)
        while self.meeting.add("traced", 0) < self.mesh.size:
            time.sleep(1e-4)

    def memory_peak(self) -> int:
        dev = self.mesh.device
        return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def rank_device(device: str, rank: int) -> torch.device:
    """Rank r's device: the CPU for a CPU run, else ``cuda:{r % cards}``
    (``parallel.launch``'s rule)."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_group(backend: str, store: str, rank: int, world: int) -> None:
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when its parent dies (Linux's
    ``PR_SET_PDEATHSIG``); end now if the parent is already gone."""
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def helper_main(spec, seed, rank, world, device, backend, store, reports, parent):
    """Rank ``rank`` (1 and up) of a run: the same frames as rank 0, then
    its report ``(rank, True, report)`` or ``(rank, False, traceback)`` on
    ``reports``. The group is left after the report, as rank 0 leaves it
    after reading every report: NCCL's leaving waits for every rank."""
    _die_with(parent)
    faulthandler.register(signal.SIGUSR1, all_threads=True)  # a stack when it hangs
    try:
        torch.set_num_threads(1)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_group(backend, store, rank, world)
        from octree_tracer_tpu_torch.parallel.mesh import make_mesh

        frames = Frames(spec, seed, make_mesh(device=dev), store)
        frames.warm()
        last = {}

        def op(i):
            img, res = frames.frame(i)
            frames.sync()
            last.update(i=i, out=(img, res.hit, res.index))

        # Rank 0's flags end the window: no deadline of this rank's own.
        yardstick.Window(math.inf).run(op, frames.stop())
        trace = frames.profile() if frames.last_flag == TRACE else None
        img, hit, index = (t.cpu().numpy() for t in last["out"])
        reports.put((rank, True, {
            "frames": last["i"] + 1, "memory_peak_bytes": frames.memory_peak(),
            "last": (img, hit, index), "trace": trace,
            "forbidden": harness.forbidden_modules(sys.modules)}))
    except BaseException:
        reports.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    dist.destroy_process_group()


# The function each spawned rank runs (tests put a faulty one in its place).
HELPER = helper_main


class Ranks:
    """Ranks 1 and up of a run: spawned at once, joined by rank 0 into one
    process group, their reports collected, and ended in every case."""

    def __init__(self, spec: dict, seed: int, device: torch.device):
        from octree_tracer_tpu_torch.parallel.launch import backend_for

        self.world = world = int(spec["cell"]["chips"])
        self.backend = backend_for(device, world)
        self.dir = tempfile.mkdtemp(prefix="portbench_ranks_")
        self.store = os.path.join(self.dir, "store")
        ctx = mp.get_context("spawn")  # a process forked after CUDA starts cannot use it
        self.reports = ctx.Queue()
        self.procs = [ctx.Process(target=HELPER, name=f"rank{r}", daemon=True,
                                  args=(spec, seed, r, world, str(device.type), self.backend,
                                        self.store, self.reports, os.getpid()))
                      for r in range(1, world)]
        for p in self.procs:
            p.start()
        self.failed: dict[int, str] = {}
        self.done = threading.Event()  # set once every report is in, or the ranks end
        threading.Thread(target=self._watch, daemon=True).start()

    def join(self, device: torch.device):
        """Rank 0 into the group; its mesh."""
        from octree_tracer_tpu_torch.parallel.mesh import make_mesh

        init_group(self.backend, self.store, 0, self.world)
        return make_mesh(device=device)

    def collect(self) -> list[dict]:
        """Every other rank's report, in rank order; raises with the
        tracebacks of the ranks that failed or died, or that loaded a
        forbidden module."""
        got, deadline = {}, time.monotonic() + REPORT_S
        while len(got) < self.world - 1:
            try:
                rank, ok, value = self.reports.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in self.procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{dead[0].name} exited with code "
                                       f"{dead[0].exitcode} and no report") from None
                if time.monotonic() > deadline:
                    for p in self.procs:  # each prints its threads' stacks
                        if p.is_alive():
                            os.kill(p.pid, signal.SIGUSR1)
                    time.sleep(2.0)
                    raise RuntimeError(f"ranks {sorted(set(range(1, self.world)) - set(got))} "
                                       f"did not report within {REPORT_S} s") from None
                continue
            if not ok:
                self.failed[rank] = value
                raise RuntimeError(self.tracebacks())
            got[rank] = value
        self.done.set()
        for rank, r in sorted(got.items()):
            if r["forbidden"]:
                print(f"portbench: rank {rank} loaded JAX or the JAX package: "
                      f"{', '.join(r['forbidden'])}", file=sys.stderr)
        found = {rank: r["forbidden"] for rank, r in got.items() if r["forbidden"]}
        if found:
            raise RuntimeError(f"JAX or the JAX package loaded on ranks {sorted(found)}")
        return [got[r] for r in range(1, self.world)]

    def tracebacks(self, grace: float = 0.0) -> str:
        """The failed ranks' tracebacks, with those that arrive within
        ``grace`` seconds."""
        deadline = time.monotonic() + grace
        while True:
            try:
                rank, ok, value = self.reports.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                break
            if not ok:
                self.failed[rank] = value
        return "\n".join(f"rank {r} of {self.world} failed:\n{self.failed[r]}"
                         for r in sorted(self.failed))

    def close(self) -> None:
        """Leave the group with the other ranks, each of which ends after
        its report; one that has not within 30 s is killed."""
        self.done.set()
        if dist.is_initialized():
            dist.destroy_process_group()
        self._end(wait=30.0)

    def _end(self, wait: float) -> None:
        for p in self.procs:
            p.join(timeout=wait)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.dir, ignore_errors=True)

    def fail(self, exc: BaseException):
        """Rank 0 failed, or a collective did because a rank died: end the
        ranks and raise with the failed ranks' tracebacks. Rank 0 leaves a
        gloo group; it stays in an NCCL group, whose leaving would wait for
        the ranks just ended, until the process ends."""
        found = self.tracebacks(grace=5.0)
        self.done.set()
        self._end(wait=0.0)
        if dist.is_initialized() and self.backend == "gloo":
            dist.destroy_process_group()
        if found and found not in str(exc):
            raise RuntimeError(found) from exc
        raise exc

    def _watch(self) -> None:
        """End the run, with the tracebacks, when a rank has died and rank
        0 stays stuck (in a collective that waits on it) for ``HANG_S``."""
        while not self.done.wait(0.5):
            dead = [p for p in self.procs if p.exitcode not in (None, 0)]
            if dead and not self.done.wait(HANG_S):
                print(f"portbench: {dead[0].name} exited with code {dead[0].exitcode} and "
                      f"rank 0 is stuck\n{self.tracebacks(grace=1.0)}", file=sys.stderr,
                      flush=True)
                for p in self.procs:
                    p.kill()
                os._exit(5)


class Run(Base):
    OP = "frame"

    def setup(self) -> None:
        self.ranks = Ranks(self.spec, self.seed, self.device)
        try:
            s, t = self.settings, self.traffic
            self.words_np = scenes.pool_words(s)
            if self.on_card:  # built once, before the other ranks' first kernel
                from octree_tracer_tpu_torch import kernels

                kernels.library()
            self.frames = Frames(self.spec, self.seed, self.ranks.join(self.device),
                                 self.ranks.store, self.words_np)
            self.poses = self.frames.poses
            self.kept: dict = {}
            self.samples = set(self.sample(t["sample_below"], t["samples"]))
            self.frames.warm()
        except BaseException as exc:
            self.ranks.fail(exc)

    def measure(self, seconds: float, trace: bool) -> None:
        try:
            self._measure(seconds, trace)
        except BaseException as exc:
            self.ranks.fail(exc)

    def _measure(self, seconds: float, trace: bool) -> None:
        frames = self.frames
        self.window = w = yardstick.Window(seconds)

        def op(i):
            img, res = frames.frame(i)
            frames.sync()
            if i in self.samples:
                self.kept[i] = (img, res.hit, res.index)
            self.last = (i, (img, res.hit, res.index))

        # The window ends at the first flag after the deadline, which every
        # rank reads: all ranks run the same frames.
        w.run(op, frames.stop(TRACE if trace else STOP))
        self.attempted = w.count
        i, out = self.last
        self.kept[i] = out
        if trace:
            self.trace = frames.profile()
        self.reports = self.ranks.collect()
        self.rank_traces = [self.trace] + [r["trace"] for r in self.reports] if trace else None
        s = self.settings
        self.gather_bytes = yardstick.gather_frame_bytes(s["width"] * s["height"],
                                                         self.ranks.world)
        self.details = [{"rank": r, "frames": rep["frames"],
                         "memory_peak_bytes": rep["memory_peak_bytes"]}
                        for r, rep in enumerate([{"frames": w.count,
                                                  "memory_peak_bytes": frames.memory_peak()}]
                                                + self.reports)]
        self.details[0]["backend"] = self.ranks.backend
        for d, t in zip(self.details, self.rank_traces or ()):
            d.update(busy_s=t["busy_s"], window_s=t["window_s"],
                     **{k + "_ms": 1e3 * (readers.trace_kernel_s(t, pattern) or 0.0)
                        for k, pattern in (("k1", readers.K1), ("gather", readers.ALL_GATHER))})

    def memory_peak(self) -> int:
        return max(d["memory_peak_bytes"] for d in self.details)

    def release(self) -> None:
        del self.frames
        self.ranks.close()
        self.free_cache()

    def check(self) -> dict:
        words = ref_trace.widen(torch.from_numpy(self.words_np.astype(np.int64)).to(self.device))
        diffs = pixels = 0
        for i, (img, hit, index) in sorted(self.kept.items()):
            pos, look = self.poses[i % len(self.poses)]
            ref = compare.reference_frame(words, pos, look, self.settings, self.device)
            diffs += compare.frame_diffs(img, hit, index, ref)
            pixels += hit.numel()
        lim = self.limits()
        return {"frame_diff_pct": (self.percent(diffs, pixels), lim["frame_diff_pct"]),
                "rank_frame_off": (self.rank_frame_off(), lim["rank_frame_off"])}

    def rank_frame_off(self) -> int:
        """Pixels of the last frame whose u8 colour, hit or hit slot on any
        other rank differs from rank 0's."""
        mine = [t.cpu().numpy() for t in self.last[1]]
        img0 = mine[0].reshape(-1, 3)
        off = np.zeros(img0.shape[0], dtype=bool)
        for rep in self.reports:
            img, hit, index = rep["last"]
            off |= (img.reshape(-1, 3) != img0).any(axis=1)
            off |= hit.reshape(-1) != mine[1].reshape(-1)
            off |= index.reshape(-1) != mine[2].reshape(-1)
        return int(off.sum())
