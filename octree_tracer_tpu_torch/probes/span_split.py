"""The program's span split of a benchmark fly cell: one traced run of the
cell (``portbench``), then the span records of its profiled stretch summed
by name (ms a step, count), the counters, the chunk loads and the steps that
requested them, the idle gaps and the checks, as one JSON line. On the card,
from the repository root:

    python -m octree_tracer_tpu_torch.probes.span_split CELL SEED [--seconds S]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> None:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser()
    p.add_argument("cell")
    p.add_argument("seed", type=int)
    p.add_argument("--seconds", type=float, default=40.0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    from ..utils import timing

    torch.set_num_threads(1)
    spec = harness.cell_spec(harness.benchmark(), args.cell)
    run = harness.execute(spec, args.seed, args.seconds, True, torch.device("cuda", 0),
                          t_start)
    line = harness.result_line(spec, run, True, harness.device_info(torch, 1))
    ops = run.trace["ops"]
    recs = timing.records()
    spans = [r for r in recs if isinstance(r, timing.Span)]
    by: dict = {}
    for s in spans:
        t, n = by.get(s.name, (0.0, 0))
        by[s.name] = (t + (s.end_ns - s.start_ns) * 1e-6, n + 1)
    counts: dict = {}
    for c in recs:
        if isinstance(c, timing.Count):
            counts[c.name] = counts.get(c.name, 0) + c.n
    steps = {s.step for s in spans if s.name == "session.update"}
    loads = [s for s in spans if s.name == "world.load_chunk"]
    json.dump({"cell": args.cell, "seed": args.seed, "correct": line["correct"], "ops": ops,
               "metrics": {k: round(v["value"], 4) for k, v in line["metrics"].items()},
               "ms_a_step": {k: [round(t / ops, 3), n] for k, (t, n) in
                             sorted(by.items(), key=lambda kv: -kv[1][0])},
               "counts": counts, "dropped": timing.dropped(), "loads": len(loads),
               "loads_with_update_step": sum(s.step in steps for s in loads),
               "gaps": line["breakdown"]["idle_gaps"], "checks": line["checks"]},
              sys.stdout)
    print()


if __name__ == "__main__":
    main()
