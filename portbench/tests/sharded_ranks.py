"""Faults planted in the ranks of a ``sharded`` run: in the test process,
which is rank 0, through ``monkeypatch``, and in the spawned ranks by
``faulty_helper``, which each rank runs in place of the driver's helper.
The cell's traffic names the fault (``test_fault``) and the ranks it is
planted in (``test_fault_ranks``)."""

import sys
import types

from portbench import yardstick
from portbench.drivers import sharded


def alter_frame(render_frame):
    """An answer altered where it is produced: every 5th pixel's red."""
    def broken(*a, **k):
        img, res, visits = render_frame(*a, **k)
        img = img.clone()
        img.view(-1, 3)[::5, 0] ^= 0x40
        return img, res, visits
    return broken


def half_frame(render_frame):
    """Half of the batch left out: the lower half of the rank's rows never
    traced (misses, grey)."""
    import torch

    def broken(*a, **k):
        img, res, visits = render_frame(*a, **k)
        n = res.hit.shape[0] // 2
        img = img.clone()
        img.view(-1, 3)[n:] = 124
        res = res._replace(hit=torch.cat([res.hit[:n], torch.zeros_like(res.hit[n:])]),
                           index=torch.cat([res.index[:n], torch.full_like(res.index[n:], -1)]))
        return img, res, visits
    return broken


def local_only(gather_frame):
    """The exchange between ranks left out: each rank's frame is its own
    block of rows in every block's place."""
    import torch

    from octree_tracer_tpu_torch.render import tracer

    def broken(mesh, img, result):
        n = mesh.size
        return torch.cat([img] * n), tracer.TraceResult(*(torch.cat([f] * n) for f in result))
    return broken


def alter_gathered(gather_frame):
    """This rank's gathered frame altered after the gather: every 5th
    pixel's red."""
    def broken(mesh, img, result):
        img, result = gather_frame(mesh, img, result)
        img = img.clone()
        img.view(-1, 3)[::5, 0] ^= 0x40
        return img, result
    return broken


def raising(frame):
    """A rank that raises at its third frame of the window."""
    calls = []

    def broken(self, i):
        calls.append(i)
        if len(calls) == self.traffic["warm_frames"] + 3:
            raise ValueError("planted fault: a rank raises in its window")
        return frame(self, i)
    return broken


def late_start(profile):
    """A rank whose traced stretch is ready two seconds after the others'
    (a profiler slow to start)."""
    import time

    def late(op, count, sync, labels=(), start=None):
        def slow():
            time.sleep(2.0)
            if start:
                start()
        return profile(op, count, sync, labels, start=slow)
    return late


def plant(fault: str, setattr_=setattr) -> None:
    from octree_tracer_tpu_torch.parallel import mesh as pmesh
    from octree_tracer_tpu_torch.render import tracer

    if fault == "altered":
        setattr_(tracer, "render_frame", alter_frame(tracer.render_frame))
    elif fault == "half":
        setattr_(tracer, "render_frame", half_frame(tracer.render_frame))
    elif fault == "no_exchange":
        setattr_(pmesh, "gather_frame", local_only(pmesh.gather_frame))
    elif fault == "alter_gathered":
        setattr_(pmesh, "gather_frame", alter_gathered(pmesh.gather_frame))
    elif fault == "late_profiler":
        setattr_(yardstick, "profile", late_start(yardstick.profile))
    elif fault == "raise":
        setattr_(sharded.Frames, "frame", raising(sharded.Frames.frame))
    elif fault == "forbidden":
        sys.modules["octree_tracer_tpu.planted"] = types.ModuleType("octree_tracer_tpu.planted")
    else:
        raise ValueError(f"no fault {fault!r}")


def faulty_helper(spec, seed, rank, *args):
    t = spec["traffic"]
    if rank in t.get("test_fault_ranks", ()):
        plant(t["test_fault"])
    return sharded.helper_main(spec, seed, rank, *args)
