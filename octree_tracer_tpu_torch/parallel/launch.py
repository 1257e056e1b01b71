"""Start a group of rank processes and collect what each returns.

``run_ranks(fn, world_size, device, *args)`` starts ``world_size``
processes with the ``spawn`` start method (a process forked after CUDA is
initialised cannot use the card), initialises one process group in each
from a ``file://`` store in a fresh temporary directory (no TCP port, so
concurrent groups on one host never collide), calls ``fn(mesh, *args)`` on
every rank, destroys the group in a ``finally`` and returns the ranks'
results in rank order. ``fn`` must be importable by name (a module-level
function of a module that the rank processes can import) and return
something picklable; a rank's exception is raised in the caller with its
traceback, and the other ranks are ended.

The backend follows the devices, as a rule and not as a fallback:

- NCCL when every rank has a card of its own (``world_size`` at most
  ``torch.cuda.device_count()``): rank r on ``cuda:r``;
- gloo when ranks share a card (NCCL refuses two ranks on one GPU): rank r
  on ``cuda:{r % device_count}``; the tensors stay on the card, and gloo
  moves them through the host;
- gloo on CPU processes when the caller asks for ``"cpu"`` (the plain
  versions, as the tests run them).

Nothing here imports JAX, and neither may ``fn``'s module: each rank process
imports it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .. import kernels

# Seconds a group may run, and a collective may wait, before it is ended.
TIMEOUT_S = 900.0


def backend_for(device, world_size: int) -> str:
    """The process group backend for ``world_size`` ranks on ``device``'s
    type (see the module docstring)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    kernels.resolve_device(device)
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def _rank_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(fn, rank, world_size, device, backend, store, results, args):
    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            from .mesh import make_mesh

            out = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))


def _failures(results, world_size: int, failed: dict, grace: float = 2.0) -> str:
    """Every rank's traceback that arrives within ``grace`` seconds of the
    first: a rank that fails ends its group, so the others' collectives
    fail next, and the first report is not always the cause."""
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        try:
            rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            failed[rank] = value
    return "\n".join(f"rank {r} of {world_size} failed:\n{failed[r]}" for r in sorted(failed))


def run_ranks(fn, world_size: int, device="cuda", *args) -> list:
    """``fn(mesh, *args)`` on ``world_size`` rank processes; their results
    in rank order. Raises RuntimeError with the tracebacks of the ranks that
    failed, or when the ranks take longer than ``TIMEOUT_S``."""
    backend = backend_for(device, world_size)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ot_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn, r, world_size, str(device), backend, store,
                                   results, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        done = False
        try:
            out, deadline = {}, time.monotonic() + TIMEOUT_S
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"{dead[0].name} exited with code "
                                           f"{dead[0].exitcode} and no result") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"ranks took longer than {TIMEOUT_S} s") from None
                    continue
                if not ok:
                    raise RuntimeError(_failures(results, world_size, {rank: value}))
                out[rank] = value
            done = True
        finally:
            for p in procs:  # after a failure the others may wait in a collective
                p.join(timeout=30.0 if done else 0.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world_size)]
