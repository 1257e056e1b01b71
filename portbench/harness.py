"""One run of one cell of the benchmark, driven by data.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration, traffic mix and metrics. Everything that belongs to one of
them sits in a file of its own, found by name:

- a configuration: ``portbench/configs/<config>.json`` (the file that
  ``BENCHMARK.json`` gives), which names its ``scene`` builder
  (``portbench/scenes.py``);
- a traffic mix: ``portbench/traffic/<traffic>.json``, parameters that the
  driver it names (``portbench/drivers/<driver>.py``) reads;
- a metric, end to end or per layer: ``portbench/metrics/<name>.py``, whose
  ``read(run)`` returns its value, or None where it finds nothing to read.

A run sets up (counted in ``setup_s``), measures for ``--seconds`` seconds,
with ``--trace 1`` profiles a short stretch after the window, reads
``memory_peak_bytes``, frees the program's state, checks what the window
produced against the plain reference (``portbench/reference``), and prints
one JSON line. It exits with 3, printing no result, without enough CUDA
cards, and with 4 if a module of JAX or of the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "octree_tracer_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's workload entry, configuration entry, configuration file,
    traffic file and its metrics of each kind, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config": config,
            "settings": load_json(os.path.join(ROOT, config["file"])),
            "traffic": load_json(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json")),
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def reader(name: str):
    """The ``read`` function of metric ``name``
    (``portbench/metrics/<name>.py``)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def read_metrics(run, metrics: list[dict]) -> dict:
    """Each metric's value as its reader gives it; a metric whose reader
    finds nothing is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Set up, measure and check one run of the cell ``spec`` on ``device``;
    returns the driver's run object, whose metrics and checks are read
    next."""
    driver = importlib.import_module("portbench.drivers." + spec["traffic"]["driver"])
    run = driver.Run(spec, seed, device)
    run.setup()
    run.setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    run.measure(seconds, trace)
    run.memory_peak_bytes = run.memory_peak()
    run.release()
    t1 = time.perf_counter()
    run.checks = run.check()
    run.phase_s = {"setup": run.setup_s, "measure": t1 - t0, "check": time.perf_counter() - t1}
    return run


def result_line(spec: dict, run, trace: bool, device: dict) -> dict:
    metrics = read_metrics(run, spec["per_layer"] if trace else spec["end_to_end"])
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    correct = all(v <= lim for v, lim in run.checks.values())
    device = dict(device, memory_peak_bytes=int(run.memory_peak_bytes))
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv, t_start: float) -> int:
    args = parse(argv)
    spec = cell_spec(benchmark(), args.workload)
    chips = int(spec["cell"]["chips"])
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = execute(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                  t_start)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: JAX or the JAX package loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    line = result_line(spec, run, bool(args.trace), device_info(torch, chips))
    print("portbench: " + ", ".join(f"{k} {v:.2f} s" for k, v in run.phase_s.items()),
          file=sys.stderr)
    for detail in getattr(run, "details", []):
        print("portbench: " + json.dumps(detail), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
