#!/usr/bin/env python3
"""The readings that each limit of ``limits/<cell>.json`` is set from: the
program's numbers over many seeds (the lower reading: the largest that
sound runs give) and the control's (the upper: the smallest), on the card
at the cell's own size.

The control is the reference put in the program's place and computed in
bfloat16, the precision below the float32 that the renderer states: its
frames, its visits and candidate lists, judged by the same comparison
against the float32 reference.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ... --out <file.json>

The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import compare, harness  # noqa: E402
from portbench.reference import select as ref_select  # noqa: E402
from portbench.reference import trace as ref_trace  # noqa: E402

BF16 = torch.bfloat16


def packed_from(sub: torch.Tensor, unsub: torch.Tensor, caps: tuple[int, int]) -> np.ndarray:
    """Candidate masks in the program's packed form: both counts, then each
    list's first ``cap`` slots in slot order, -1 after."""
    out = [int(sub.sum()), int(unsub.sum())]
    for mask, cap in ((sub, caps[0]), (unsub, caps[1])):
        idx = torch.nonzero(mask).squeeze(1)[:cap].cpu().numpy()
        out += list(idx) + [-1] * (cap - idx.shape[0])
    return np.asarray(out, np.int64)


def control(run) -> dict:
    """The control's numbers on the frames (and candidate lists) the run
    kept: the bfloat16 reference against the float32 one."""
    diffs = pixels = cand = cand_ref = 0
    steps = False
    for i, k in sorted(run.kept.items()):
        # A Session step keeps its pose, its pool and its candidate lists; a
        # frame keeps its outputs, drawn from the run's poses and pool.
        fly = isinstance(k, dict)
        steps |= fly
        if fly:
            pos, look, words = k["pos"], k["look"], ref_trace.widen(k["words"])
        else:
            pos, look = run.poses[i % len(run.poses)]
            words = ref_trace.widen(torch.from_numpy(run.words_np.astype(np.int64))
                                    .to(run.device))
        ref = compare.reference_frame(words, pos, look, run.settings, words.device, fly)
        low = compare.reference_frame(words, pos, look, run.settings, words.device, fly, BF16)
        diffs += compare.frame_diffs(low["u8"], low["hit"], low["index"], ref)
        pixels += ref["hit"].numel()
        if fly:
            sel = ref_trace.widen(k["sel_words"])
            caps = k["caps"] or (65536, 65536)
            packed = packed_from(*ref_select.candidates(sel, low["visits"], k["node_len"]), caps)
            d = compare.candidate_diffs(packed, caps, sel, words, ref["visits"], k["node_len"])
            cand, cand_ref = cand + d["diffs"], cand_ref + d["reference"]
    out = {"frame_diff_pct": run.percent(diffs, pixels)}
    if steps:
        out["candidate_diff_pct"] = run.percent(cand, cand_ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    spec = harness.cell_spec(harness.benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
           "program": {}, "control": {}}
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        run = harness.execute(spec, seed, args.seconds, False, dev, time.perf_counter())
        if seed in args.seeds:
            out["program"][seed] = {k: v for k, (v, _) in run.checks.items()}
        if seed in args.control_seeds:
            out["control"][seed] = control(run)
        print(json.dumps({"seed": seed, "program": out["program"].get(seed),
                          "control": out["control"].get(seed)}), flush=True)
        del run
        torch.cuda.empty_cache()
    for kind in ("program", "control"):
        names = {k for v in out[kind].values() for k in v}
        out[kind + "_extreme"] = {
            n: (max if kind == "program" else min)(v[n] for v in out[kind].values() if n in v)
            for n in names}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("program_extreme", "control_extreme")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
