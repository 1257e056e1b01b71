"""K1's registers form by form across source trees: each tree's
``csrc/trace.cu`` compiled alone with the port's flags (``ptxas -v``), and
every form it shares with the first tree compared.

    python -m octree_tracer_tpu_torch.probes.k1_registers TREE [TREE ...]

Each TREE is a directory holding an ``octree_tracer_tpu_torch`` package: a
``git archive`` of an earlier commit, or this tree. A form is a kernel
(``trace_kernel``, ``trace_start_kernel`` or ``trace_seed_kernel``) with
its template flags. One line a tree: how many forms it has, the forms it
shares with the first tree whose registers or spill bytes differ, and how
many forms the first tree lacks. Exits 1 if a shared form differs. Needs ``nvcc``, not a card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile


def form(mangled: str) -> str | None:
    """``kernel<flags>`` of a K1 instantiation's mangled name, or None for
    another kernel."""
    m = re.search(r"(trace(?:_start|_seed)?_kernel)I((?:L[bi]\d+E)+)E", mangled)
    if not m:
        return None
    return f"{m[1]}<{','.join(re.findall(r'L[bi](\d+)E', m[2]))}>"


def forms(log: str) -> dict:
    """{form: (registers, spill store bytes, spill load bytes)} of ptxas's
    ``-v`` report."""
    from octree_tracer_tpu_torch import kernels

    return {form(fn): tuple(rest) for fn, *rest in kernels.register_report(log)
            if form(fn) is not None}


def compare(base: dict, other: dict) -> tuple[dict, list]:
    """(shared forms whose registers or spills differ: (base, other), forms
    of ``other`` that ``base`` lacks)."""
    changed = {k: (base[k], v) for k, v in other.items() if k in base and base[k] != v}
    return changed, sorted(k for k in other if k not in base)


def compile_log(tree: str) -> str:
    """ptxas's report of ``tree``'s ``trace.cu``, compiled alone."""
    from octree_tracer_tpu_torch import kernels

    csrc = os.path.join(tree, "octree_tracer_tpu_torch", "csrc")
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, f"-I{csrc}", "-c", "-o",
             os.path.join(d, "trace.o"), os.path.join(csrc, "trace.cu")],
            capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tree}:\n{out.stdout}{out.stderr}")
    return out.stdout + out.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    base = forms(compile_log(args.trees[0]))
    print(f"{args.trees[0]}: {len(base)} forms, registers "
          f"{min(v[0] for v in base.values())}-{max(v[0] for v in base.values())}")
    ok = True
    for tree in args.trees[1:]:
        other = forms(compile_log(tree))
        changed, new = compare(base, other)
        ok = ok and not changed
        print(f"{tree}: {len(other)} forms; {len(other) - len(new)} shared with "
              f"{args.trees[0]}, changed {changed}; {len(new)} new, registers "
              f"{sorted({other[k][0] for k in new})}, spills "
              f"{sorted({other[k][1:] for k in new})}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
