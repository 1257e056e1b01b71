"""The gather probes of ``probes/gather_probe.py`` and
``probes/pallas_min_probe.py`` on the card: every Pallas row gather, row copy
and scalar add of those scripts, at their shapes, through kernels K8
(``gather_rows``) and K9 (``add_scalar``).

    python -m octree_tracer_tpu_torch.probes.gather_probe [name ...] [--json PATH]

Names are the JAX probes' (``p1``, ``p4``, ``p5``, ``t1`` ... ``t14b``; none
runs them all). Each line prints ``OK=`` (the kernel's output equals the
probe's own reference array, built with NumPy as the JAX probe builds it),
``plain=`` (it equals the plain PyTorch version), and on the card the
kernel's ns per output row, ``table[idx]``'s (or ``x + c``'s) and the
kernel's bound: its bytes over 3.35 TB/s, counting each distinct table row
its starts reach once (:func:`gather.gather_bytes`), each output byte once
and 4 bytes a start. Times are device times (CUDA events behind a spin
kernel, so the host's enqueue is not in them). On the TPU the variants of
one shape differed in how their DMAs were issued (rows in flight, chunking,
unrolling); on Hopper they are one kernel, so they share a measurement
configuration and their lines differ only in name.

``p1`` sweeps the table from 2^15 to 2^22 rows of 8 words (1 MB to 128 MB)
with 16 index sets of 2^18 random rows taken in turn, so the table's share
resident in the 50 MB L2 falls as the table grows, as the traversal's pool
reads find it. The other lines repeat their probe's one index set. ``p2``
and ``p3`` of the JAX probe are jnp loops, not Pallas kernels, and are not
ported.

``main(device=...)`` runs on the card unless asked for the CPU, where it
checks every line against the plain versions at ``shrink``-reduced table
and index counts and times nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..state import to_numpy_u32, u32_to_device
from .gather import (add_scalar, add_scalar_plain, gather_bytes, gather_rows,
                     gather_rows_plain, upload_starts)

W = 1 << 18  # index count of the JAX probes
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
P1_SETS = 16
NAMES = ("p1", "p4", "p5", "t1", "t2", "t3", "t4", "t5", "t6", "t7", "t8", "t9",
         "t10", "t10b", "t11", "t11s", "t11g", "t12", "t13", "t14", "t14b")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn``, from CUDA events. A spin kernel
    holds the stream while the host enqueues the timed calls, so the events
    see device time only: at the probes' small shapes the host's enqueue
    (the wrapper's checks, ctypes, allocation) takes longer than the
    kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * reps * enqueue_s + 1e-3, 0.5) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turn(fns: dict, rounds: int, reps: int, n_calls: int = 1) -> dict:
    """Median and range of ``rounds`` device times (ms a call) of each
    function in ``fns``, timed in turn, the order reversed every other
    round."""
    names = list(fns)
    samples = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            samples[k].append(cuda_ms(fns[k], reps) / n_calls)
    return {k: {"median": float(np.median(v)), "range": [min(v), max(v)]}
            for k, v in samples.items()}


class _Probe:
    """Runs the lines and keeps their results."""

    def __init__(self, device, shrink: int, reps: int, log, retimed=()):
        self.dev = device
        self.shrink = shrink
        self.reps = reps
        self.log = log
        self.timed = device.type == "cuda"
        self.results: list[dict] = []
        self.retimed = set(retimed)
        self.fns: dict[str, tuple] = {}  # retimed line -> its kernel and library calls

    def n(self, count: int) -> int:
        """A row or index count of the probes, reduced by ``shrink``."""
        return max(count >> self.shrink, 16)

    def _times(self, name, kernel_fn, plain_fn, library_fn, n_calls: int = 1) -> dict:
        if name in self.retimed:
            self.fns[name] = (kernel_fn, library_fn, n_calls)
        if not self.timed:
            return {}
        return {"ms": cuda_ms(kernel_fn, self.reps) / n_calls,
                "plain_ms": cuda_ms(plain_fn, self.reps) / n_calls,
                "library_ms": cuda_ms(library_fn, self.reps) / n_calls}

    def _start(self) -> None:
        self._launched = dict(kernels.LAUNCHES)

    def _emit(self, name: str, res: dict, rows: int, what: str) -> dict:
        res.update(name=name, rows=rows, launches=kernels.LAUNCHES[res["kernel"]]
                   - self._launched[res["kernel"]])
        if self.timed:
            ns = {k: res[k] * 1e6 / rows for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            t = (f" kernel {ns['ms']:.3f} ns/row, {res['library']} {ns['library_ms']:.3f} "
                 f"ns/row, plain {ns['plain_ms']:.3f} ns/row, bound {ns['bound_ms']:.4f} "
                 f"ns/row ({res['ms'] * 1e3:.2f} us a call)")
        else:
            t = " (not timed on the CPU)"
        self.log(f"{name}: OK={res['ok']} plain={res['plain_ok']}{t}; {what}; "
                 f"{res['launches']} launches")
        self.results.append(res)
        return res

    def gather(self, name, table_np, starts_sets, rows=1, want=None, extra_ok=None,
               what=""):
        """K8 over ``table_np`` (u32[G, w]) for each start set in turn;
        ``want`` is the probe's reference for the first set."""
        self._start()
        table = u32_to_device(table_np, self.dev)
        sets = [upload_starts(s, self.dev) for s in starts_sets]
        idx = [st.tensor.to(torch.int64) if rows == 1 else
               (st.tensor.to(torch.int64)[:, None]
                + torch.arange(rows, device=self.dev)).reshape(-1) for st in sets]
        out = gather_rows(table, sets[0], rows)
        got = to_numpy_u32(out)
        ok = want is None or np.array_equal(got, want)
        if extra_ok is not None:
            ok = ok and extra_ok(got)
        plain_ok = all(torch.equal(gather_rows(table, st, rows),
                                   gather_rows_plain(table, st.tensor, rows))
                       for st in sets)
        k = len(sets)

        def cycle(fn):
            return lambda: [fn(i) for i in range(k)]

        res = {"kernel": "gather_rows", "library": "table[idx]", "ok": bool(ok),
               "plain_ok": bool(plain_ok), "max_abs_err": 0.0 if plain_ok else float("inf")}
        res.update(self._times(name, cycle(lambda i: gather_rows(table, sets[i], rows)),
                               cycle(lambda i: gather_rows_plain(table, sets[i].tensor, rows)),
                               cycle(lambda i: table[idx[i]]), k))
        n_rows = sets[0].tensor.shape[0] * rows
        g, w = table_np.shape
        # Each set's own bytes (distinct rows read once); a call's, their mean.
        nbytes = sum(gather_bytes(s, rows, w) for s in starts_sets) / k
        res.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes, table_rows=g,
                   width=w)
        return self._emit(name, res, n_rows, what or f"{n_rows} rows of {w} words from "
                          f"a {g}-row table ({g * w * 4 / 2**20:.1f} MiB)")

    def add(self, name, x_np, c, want, what):
        """K9: ``x + c``; ``c`` a number, or a NumPy one-element array that
        goes to the device (the scalar-prefetch operand)."""
        self._start()
        x = (u32_to_device(x_np, self.dev) if x_np.dtype == np.uint32
             else torch.from_numpy(x_np).to(self.dev))
        if isinstance(c, np.ndarray):
            c = torch.from_numpy(c.view(np.int32) if c.dtype == np.uint32 else c).to(self.dev)
        out = add_scalar(x, c)
        got = to_numpy_u32(out) if x_np.dtype == np.uint32 else out.cpu().numpy()
        plain_ok = torch.equal(out, add_scalar_plain(x, c))
        res = {"kernel": "add_scalar", "library": "x + c", "ok": bool(np.array_equal(got, want)),
               "plain_ok": bool(plain_ok), "max_abs_err": 0.0 if plain_ok else float("inf")}
        lib_c = c.reshape(()) if isinstance(c, torch.Tensor) else c
        res.update(self._times(name, lambda: add_scalar(x, c), lambda: add_scalar_plain(x, c),
                               lambda: x + lib_c))
        nbytes = 2 * x_np.nbytes
        res.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
        return self._emit(name, res, x_np.shape[0], what)


def _arange_table(rows: int, width: int) -> np.ndarray:
    return np.arange(rows * width, dtype=np.uint32).reshape(rows, width)


def _row_filled_table(rows: int) -> np.ndarray:
    """Row i holds i in all 128 words (``pallas_min_probe.py:314``)."""
    return np.repeat(np.arange(rows, dtype=np.uint32)[:, None], 128, axis=1)


def _t11(pr: _Probe, name: str, w: int, g: int):
    """t11's gather of ``w`` random 128-word rows of a ``g``-row table; the
    probe checks the sum of column 0 against the indices' sum."""
    w, g = pr.n(w), pr.n(g)
    idx = np.random.default_rng(0).integers(0, g, w, dtype=np.int32)
    table = _row_filled_table(g)
    want_sum = np.uint32(idx.astype(np.uint64).sum() & 0xFFFFFFFF)
    pr.gather(name, table, [idx], 1, table[idx],
              lambda got: got[:, 0].sum(dtype=np.uint32) == want_sum)


def _rng():
    """Each JAX probe draws its indices from a fresh seed-0 generator."""
    return np.random.default_rng(0)


def run(which, pr: _Probe) -> None:
    if "p1" in which:
        pr.log("== P1 standalone row gather (16 index sets in turn) ==")
        for log_g in (15, 17, 19, 20, 21, 22):
            g, w = pr.n(1 << log_g), pr.n(W)
            table = _arange_table(g, 8)
            rng = _rng()
            sets = [rng.integers(0, g, w, dtype=np.int32) for _ in range(P1_SETS)]
            pr.gather(f"P1 G={g:>8} ({g * 32 / 1e6:6.1f} MB)", table, sets, 1,
                      table[sets[0]])
    if "p4" in which or "p5" in which:
        g, w = pr.n(1 << 20), pr.n(W)
        table = _arange_table(g, 8)
        idx = _rng().integers(0, g, w, dtype=np.int32)
        if "p4" in which:
            pr.log("== P4 Mosaic kernels ==")
            pr.gather("A per-row DMA K=8", table, [idx], 1, table[idx])
            pr.gather("B blockspec-indexed", table, [idx], 1, table[idx])
            gs = pr.n(1 << 15)
            ts = _arange_table(gs, 8)
            idxs = _rng().integers(0, gs, w, dtype=np.int32)
            pr.gather("C vmem take 1MB table", ts, [idxs], 1, ts[idxs])
        if "p5" in which:
            pr.log("== P5 Mosaic kernels (round-3 shapes) ==")
            for chunk, k in ((2048, 8), (2048, 16), (8192, 16)):
                pr.gather(f"D vmem-out DMA CHUNK={chunk} K={k}", table, [idx], 1, table[idx])
            # Shape E views the table as (G, 1, 8): the same rows.
            pr.gather("E equal-dims pipeline", table.reshape(g, 1, 8).reshape(g, 8), [idx],
                      1, table[idx])
    if "t1" in which:
        pr.add("t1", np.zeros((8, 128), np.float32), 1.0, np.ones((8, 128), np.float32),
               "f32[8, 128] + 1")
    if "t2" in which:
        pr.add("t2", np.zeros((8, 128), np.uint32), 1, np.ones((8, 128), np.uint32),
               "u32[8, 128] + 1")
    if "t3" in which:
        pr.add("t3", np.zeros((1024, 128), np.uint32), 1, np.ones((1024, 128), np.uint32),
               "u32[1024, 128] + 1")
    if "t4" in which:
        s = np.arange(8, dtype=np.int32)
        x = np.zeros((1024, 128), np.uint32)
        pr.add("t4", x, s[:1].copy(), x + np.uint32(s[0]), "u32[1024, 128] + s[0], s on the card")
    x128 = _arange_table(1024, 128)
    x8 = _arange_table(1024, 8)
    if "t5" in which:
        s = np.asarray([3, 1, 7, 0, 2, 2, 5, 4], np.int32)
        pr.gather("t5", x128, [s * 128], 128, x128.reshape(8, 128, 128)[s].reshape(1024, 128),
                  what="8 blocks of 128 rows of 128 words by index")
    if "t6" in which:
        pr.gather("t6", x128, [np.asarray([0])], 128, x128[:128], what="rows 0-127")
    if "t7" in which:
        pr.gather("t7", x128, [np.asarray([256])], 128, x128[256:384], what="rows 256-383")
    if "t8" in which:
        pr.gather("t8", x8, [np.asarray([77])], 1, x8[77:78], what="one 8-word row, j = 77")
    if "t9" in which:
        s = _rng().integers(0, 1024, 64, dtype=np.int32)
        pr.gather("t9", x8, [s], 1, x8[s], what="64 random 8-word rows")
    if "t10" in which:
        pr.gather("t10", x128, [np.asarray([77])], 1, x128[77:78],
                  what="one 128-word row, j = 77")
    if "t10b" in which:
        pr.gather("t10b", x128, [np.asarray([77])], 8, x128[77:85],
                  what="8 rows from unaligned j = 77")
    for name, w, g in (("t11", W, 1 << 18), ("t11s", W, 1 << 18), ("t11g", W, 1 << 15),
                       ("t12", W, 1 << 18), ("t13", 1 << 17, 1 << 18),
                       ("t14", 1 << 17, 1 << 18), ("t14b", 1 << 17, 1 << 18)):
        if name in which:
            _t11(pr, name, w, g)


def retime(pr: _Probe, name: str, samples: int) -> dict:
    """``samples`` device times of line ``name``'s kernel and of its library
    call, taken in turn: their medians and ranges in ms a call."""
    kernel_fn, library_fn, n_calls = pr.fns[name]
    t = time_in_turn({"kernel": kernel_fn, "library": library_fn}, samples, pr.reps, n_calls)
    return {"samples": samples, "ms_median": t["kernel"]["median"],
            "ms_range": t["kernel"]["range"], "library_ms_median": t["library"]["median"],
            "library_ms_range": t["library"]["range"]}


def main(which=None, device="cuda", shrink: int = 0, reps: int = 20, log=print,
         retimed=(), samples: int = 21) -> list[dict]:
    """Run the named probe lines (all of them by default) on ``device``;
    returns one dict per line (kernel, ok, plain_ok, rows, bytes, the line's
    kernel launches, and on the card ms, plain_ms, library_ms and bound_ms
    per call). The lines named in ``retimed`` are then timed again
    ``samples`` times, kernel and library call in turn, into their dict's
    ``retimed`` (see :func:`retime`)."""
    dev = kernels.resolve_device(device)
    which = set(which or NAMES)
    unknown = which - set(NAMES)
    if unknown:
        raise ValueError(f"unknown probe names {sorted(unknown)}; known: {NAMES}")
    pr = _Probe(dev, shrink, reps, log, retimed)
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}")
    run(which, pr)
    if pr.timed:
        for r in pr.results:
            if r["name"] in pr.fns:
                r["retimed"] = retime(pr, r["name"], samples)
    log(f"total {time.perf_counter() - t0:.1f}s")
    return pr.results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="probe lines (default: all)")
    ap.add_argument("--json", help="write the results to this file")
    args = ap.parse_args()
    results = main(args.names or None)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f)
    sys.exit(0 if all(r["ok"] and r["plain_ok"] for r in results) else 1)
