"""The comparisons that decide ``correct``: what the program produced
against what the plain reference (``reference/``) works out from the same
inputs. Each returns counts; a run's check divides them into the numbers
held against the cell's limits (``limits/<cell>.json``)."""

from __future__ import annotations

import numpy as np
import torch

from .reference import camera as ref_camera
from .reference import select as ref_select
from .reference import trace as ref_trace


def reference_frame(words: torch.Tensor, pos, look, settings: dict, device,
                    with_visits: bool = False, dtype=torch.float32) -> dict:
    """The reference's frame of the pool ``words`` (int64 u32 values) from
    a camera at ``pos`` looking along ``look``, at the configuration's
    size, field of view, sun and shadows."""
    ci = ref_camera.camera_inverse(pos, look, settings["fov"], settings["width"],
                                   settings["height"])
    origin, dirs = ref_camera.primary_rays(ci, settings["width"], settings["height"], device)
    return ref_trace.render(words, origin, dirs, settings["sun"], settings["shadows"],
                            with_visits, dtype)


def frame_diffs(u8: torch.Tensor, hit: torch.Tensor, index: torch.Tensor, ref: dict) -> int:
    """Pixels whose hit, hit leaf's slot or any u8 channel differs from the
    reference's: u8 [H, W, 3] or [N, 3], hit and index [N] (any device)."""
    dev = ref["hit"].device
    u8 = u8.to(dev).reshape(-1, 3)
    bad = (hit.to(dev).reshape(-1) != ref["hit"])
    bad |= index.to(dev).reshape(-1).to(torch.int64) != ref["index"]
    bad |= (u8 != ref["u8"]).any(dim=1)
    return int(bad.sum())


def candidate_diffs(packed: np.ndarray, caps: tuple[int, int], sel_words: torch.Tensor,
                    frame_words: torch.Tensor, visits: torch.Tensor, node_len: int) -> dict:
    """The program's packed selection ``[sub_n, unsub_n, sub[cap],
    unsub[cap]]`` against the reference's decision on ``sel_words`` (int64
    u32 values, the pool the selection read) under the visits of its own
    frame of ``frame_words`` (the pool the frame traced).

    Only slots whose word is the same in both pools are judged: a slot the
    step's patches changed holds a node the frame never traced, so its
    visits say nothing of it. On those slots: each slot the program lists
    that the reference does not name (``program_only``) and, where a list
    holds every candidate (its count within its cap), each slot the
    reference names that the list lacks (``reference_only``), per list;
    ``reference`` counts the reference's candidates."""
    sub, unsub = ref_select.candidates(sel_words, visits, node_len)
    same = (sel_words == frame_words).cpu().numpy()
    out = {"reference": 0, "sub_program_only": 0, "sub_reference_only": 0,
           "unsub_program_only": 0, "unsub_reference_only": 0}
    offset = 2
    for kind, n_prog, cap, mask in (("sub", int(packed[0]), caps[0], sub),
                                    ("unsub", int(packed[1]), caps[1], unsub)):
        listed = packed[offset: offset + min(n_prog, cap)].astype(np.int64)
        offset += cap
        ok = (listed >= 0) & (listed < mask.shape[0])
        listed = listed[ok]
        ref = mask.cpu().numpy() & same
        mine = np.zeros_like(ref)
        mine[listed] = True
        mine &= same
        out[kind + "_program_only"] = int((~ok).sum()) + int((mine & ~ref).sum())
        if n_prog <= cap:
            out[kind + "_reference_only"] = int((ref & ~mine).sum())
        out["reference"] += int(ref.sum())
    out["diffs"] = sum(v for k, v in out.items() if k.endswith("_only"))
    return out
