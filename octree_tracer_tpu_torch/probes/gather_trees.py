"""K8 and K9 across source trees: every probe line of several versions of the
port, timed in turn on one card.

    python -m octree_tracer_tpu_torch.probes.gather_trees TREE [TREE ...] \\
        [--rounds R] [--out DIR]

Each TREE is a directory holding an ``octree_tracer_tpu_torch`` package. Its
worker (see ``probes/trees.py``) builds that tree's kernels; then, line by
line, the workers run their tree's ``gather_probe.main([line])`` in turn. A
line's tables and index sets come from the same seeds in every tree. Prints,
for every probe line, each tree's median kernel time and range over the
rounds, the library call's median, and each tree's share of the bound that
the last tree counts (a later tree may count bytes differently); exits 1 if
a tree's line is not OK or differs from its plain version. Writes all
samples to ``DIR/gather_trees.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_KEYS = ("name", "ok", "plain_ok", "ms", "plain_ms", "library_ms", "bound_ms", "bytes")


def setup():
    """In a worker: build the tree's kernels; serve one probe name a request."""
    from octree_tracer_tpu_torch import kernels
    from octree_tracer_tpu_torch.probes import gather_probe

    kernels.library()

    def serve(name):
        results = gather_probe.main([name], device="cuda", log=lambda m: None)
        return [{k: r[k] for k in _KEYS if k in r} for r in results]

    return {"ready": True}, serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default="_chip/gather_trees")
    args = ap.parse_args(argv)

    import torch

    from . import trees
    from .gather_probe import NAMES

    if not torch.cuda.is_available():
        print("gather_trees: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    names = [os.path.basename(os.path.normpath(t)) for t in args.trees]
    _, replies = trees.run(args.trees, __file__, (), NAMES, args.rounds)
    samples: dict = {}  # line -> tree -> list of result dicts
    for probe in NAMES:
        for i, rounds in enumerate(replies[probe]):
            for results in rounds:
                for res in results:
                    samples.setdefault(res["name"], {n: [] for n in names})[names[i]].append(res)

    device = trees.card()
    print(f"{device}; trees {names}, {args.rounds} rounds; us a call: median [min, max], "
          f"share of the last tree's bound")
    good = True
    for line, per in samples.items():
        bound = per[names[-1]][0]["bound_ms"]
        lib = float(np.median([s["library_ms"] for n in names for s in per[n]]))
        cells = []
        for n in names:
            ms = [s["ms"] for s in per[n]]
            good = good and all(s["ok"] and s["plain_ok"] for s in per[n])
            med = float(np.median(ms))
            cells.append(f"{n} {med * 1e3:.3f} [{min(ms) * 1e3:.3f}, {max(ms) * 1e3:.3f}] "
                         f"{bound / med:.0%}")
        print(f"{line}: " + "; ".join(cells) + f"; library {lib * 1e3:.3f}; bound "
              f"{bound * 1e3:.4f} ({per[names[-1]][0]['bytes']:.0f} B)")
    with open(os.path.join(args.out, "gather_trees.json"), "w") as f:
        json.dump({"device": device, "trees": names, "samples": samples}, f)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
