"""Several source trees of the port, timed in turn on one card.

A tree is a directory holding an ``octree_tracer_tpu_torch`` package: a
``git archive`` of an earlier commit, or this tree. :func:`run` starts one
worker process a tree, with that tree as its working directory and first on
its ``PYTHONPATH``, so each worker builds and runs its own tree's kernels.
The worker loads a payload file (from this tree, so an earlier tree needs
only the port's public API) and calls its ``setup(*args)``, which prepares
the work and returns ``(ready, serve)``: a JSON object to report, and a
function from one request string to a JSON reply. Once every worker is
ready, each request goes to the workers one at a time, in tree order and in
reverse order on alternate rounds, so neighbouring trees are timed A B B A
on the same card. Payloads: ``probes/trace_steps.py`` (K1's frame passes)
and ``probes/gather_trees.py`` (every K8 and K9 probe line).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys


def _reply(proc) -> dict:
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"a worker ended with code {proc.wait()}")
    return json.loads(line)


def run(trees, payload: str, args=(), requests=("measure",), rounds: int = 4):
    """Serve ``requests`` from ``payload`` in every tree, ``rounds`` times
    each, the trees in turn. Returns ``(ready, replies)``: each tree's ready
    object in tree order, and ``replies[request][i]``, tree i's replies to
    that request, one a round."""
    procs = []
    try:
        for tree in trees:
            tree = os.path.abspath(tree)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 os.path.abspath(payload), *map(str, args)],
                cwd=tree, env={**os.environ, "PYTHONPATH": tree}, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True))
        ready = [_reply(p) for p in procs]
        replies = {}
        for request in requests:
            replies[request] = [[] for _ in procs]
            for r in range(rounds):
                for i in (range(len(procs)) if r % 2 == 0 else reversed(range(len(procs)))):
                    procs[i].stdin.write(request + "\n")
                    procs[i].stdin.flush()
                    replies[request][i].append(_reply(procs[i]))
    finally:
        for p in procs:
            if p.stdin and not p.stdin.closed:
                p.stdin.close()
            p.wait(timeout=60)
    return ready, replies


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them, else its
    name."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else torch.cuda.get_device_name(0)


def _worker(payload: str, args: list[str]) -> None:
    spec = importlib.util.spec_from_file_location("_tree_payload", payload)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ready, serve = module.setup(*args)
    print(json.dumps(ready), flush=True)
    for line in sys.stdin:
        request = line.strip()
        if not request:
            break
        print(json.dumps(serve(request)), flush=True)


if __name__ == "__main__" and len(sys.argv) >= 3 and sys.argv[1] == "--worker":
    _worker(sys.argv[2], sys.argv[3:])
