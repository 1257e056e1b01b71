"""Device-side LOD feedback: candidate selection, visit closure, patches.

The port of the JAX package's ``adaptive/feedback.py``. Two kernels, each
with its plain PyTorch version beside it:

- ``select_candidates_packed`` (K5, ``csrc/select_candidates.cu``) /
  ``select_candidates_plain``: ``feedback.py:33-92``;
- ``propagate_visits`` (K6, ``csrc/propagate_visits.cu``) /
  ``propagate_visits_plain``: ``feedback.py:96-136``.

A wrapper runs the plain version only for tensors on the CPU; on a CUDA
device it launches its kernel or raises. ``apply_patches`` is a PyTorch
index assignment (``feedback.py:139-148``); ``pad_patches`` is JAX's host
padding (``feedback.py:151``), for its callers (the port's patch path needs
no fixed shapes), and ``fast_nonzero`` is ``render.tracer``'s, which JAX's
module imports too.

Per-frame counters: ``min(visits, 15)`` is the reference's 4-bit in-word
counter, which its full re-upload zeroes every frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core.voxel import VOXEL_OFFSET
from ..render.tracer import fast_nonzero  # re-exported where JAX's feedback has it
from ..state import u32_to_device, widen_u32

# Candidate caps of the reference; it reserves word 0 of each buffer for the
# atomic counter, so its effective cap is N - 1.
MAX_SUBDIVISIONS_PER_FRAME = 1024000
MAX_UNSUBDIVISIONS_PER_FRAME = 1024000

# Slots per tile of K5 (kTile in csrc/select_candidates.cu).
SELECT_TILE = 4096

_I32 = torch.int32


def _masks(words: torch.Tensor, visits: torch.Tensor, node_len: int):
    w = widen_u32(words)
    payload = w >> 4
    slot = torch.arange(w.shape[0], device=w.device)
    valid = (w != 0) & (slot < node_len)
    counter = visits.clamp_max(15)
    sub = valid & (counter >= 4) & (payload > VOXEL_OFFSET)
    unsub = valid & (counter == 0) & (payload < VOXEL_OFFSET)
    return sub, unsub


def select_bytes(n: int, sub_cap: int, unsub_cap: int) -> int:
    """Bytes K5 must move: each slot's word and visits read once, the
    packed output written once."""
    return 8 * n + 4 * (2 + sub_cap + unsub_cap)


def select_candidates_plain(words, visits, node_len: int,
                            sub_cap: int = MAX_SUBDIVISIONS_PER_FRAME - 1,
                            unsub_cap: int = MAX_UNSUBDIVISIONS_PER_FRAME - 1,
                            offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel K5 (see ``select_candidates_packed``)."""
    n = words.shape[0]
    off = int(offset) % n
    sub, unsub = _masks(words, visits, node_len)

    def pick(mask, cap):
        ri = torch.nonzero(torch.roll(mask, -off)).squeeze(1)[:cap]
        out = torch.full((cap,), -1, dtype=_I32, device=words.device)
        out[: ri.shape[0]] = ((ri + off) % n).to(_I32)
        return out

    counts = torch.stack([sub.sum(), unsub.sum()]).to(_I32)
    return torch.cat([counts, pick(sub, sub_cap), pick(unsub, unsub_cap)])


def select_candidates_packed(words, visits, node_len: int,
                             sub_cap: int = MAX_SUBDIVISIONS_PER_FRAME - 1,
                             unsub_cap: int = MAX_UNSUBDIVISIONS_PER_FRAME - 1,
                             offset: int = 0) -> torch.Tensor:
    """LOD candidates of the pool, as one int32 array ``[sub_n, unsub_n,
    sub_idx[sub_cap], unsub_idx[unsub_cap]]``, so the host reads back once.

    A slot is valid when its word is not 0 and it lies below ``node_len``.
    Valid filled leaves with ``min(visits, 15) >= 4`` are subdivide
    candidates, valid interiors with no visit are collapse candidates. Each
    list holds its first ``cap`` candidates in slot order starting at
    ``offset`` and wrapping, so a cap overflow cannot starve high slots while
    the caller advances the offset; -1 fills the rest. ``sub_n`` and
    ``unsub_n`` count every candidate, past the caps too. On a CUDA device
    this launches kernel K5; on the CPU it is ``select_candidates_plain``."""
    dev = words.device
    n = words.shape[0]
    kernels.check(words, "words", _I32, (None,), dev)
    kernels.check(visits, "visits", _I32, (n,), dev)
    if n == 0 or sub_cap < 0 or unsub_cap < 0:
        raise ValueError("need a non-empty pool and caps >= 0")
    if not kernels.uses_kernel(dev):
        return select_candidates_plain(words, visits, node_len, sub_cap,
                                       unsub_cap, offset)
    # One buffer, set to all ones by the kernel's memset: the scan's status
    # words (8 bytes an item) and ticket (8 with padding), then the output,
    # which the memset fills with -1.
    n_items = -(-n // SELECT_TILE) + 1
    head = 2 * n_items + 2
    buf = torch.empty(head + 2 + sub_cap + unsub_cap, dtype=_I32, device=dev)
    out = buf[head:]
    vec = words.data_ptr() % 16 == 0 and visits.data_ptr() % 16 == 0
    kernels.launch("select_candidates", "ot_select_candidates", dev,
                   kernels.ptr(words), kernels.ptr(visits), n, int(node_len),
                   int(offset) % n, sub_cap, unsub_cap, kernels.ptr(buf),
                   4 * buf.numel(), kernels.ptr(out), int(vec))
    return out


def select_candidates(words, visits, node_len: int,
                      sub_cap: int = MAX_SUBDIVISIONS_PER_FRAME - 1,
                      unsub_cap: int = MAX_UNSUBDIVISIONS_PER_FRAME - 1,
                      offset: int = 0):
    """``select_candidates_packed`` unpacked: (sub_idx, sub_n, unsub_idx,
    unsub_n)."""
    packed = select_candidates_packed(words, visits, node_len, sub_cap,
                                      unsub_cap, offset)
    return (packed[2: 2 + sub_cap], packed[0],
            packed[2 + sub_cap:], packed[1])


def propagate_visits_plain(words, visits, passes: int) -> torch.Tensor:
    """Plain PyTorch version of kernel K6 (see ``propagate_visits``)."""
    w = widen_u32(words)
    payload = w >> 4
    interior = (payload < VOXEL_OFFSET) & (w != 0)
    n = visits.shape[0]
    pad = (-n) % 8
    rows = (n + pad) // 8
    grp = torch.where(interior, payload, 0).div(8, rounding_mode="floor")
    grp = grp.clamp(0, rows - 1)
    v = visits
    for _ in range(passes):
        v8 = torch.cat([v, v.new_zeros(pad)]) if pad else v
        child_any = (v8.reshape(rows, 8) > 0).any(dim=1)[grp]
        v = torch.where(interior & child_any & (v == 0), 1, v)
    return v


def propagate_visits(words, visits, passes: int) -> torch.Tensor:
    """Upward closure of the visit set: each of ``passes`` Jacobi passes
    marks 1 on every interior with no visit whose child group has one.

    A warp or skip restart resumes a descent below ancestors that a full
    root descent would have read, so a counted frame that rode a table
    under-marks shallow interiors. Every descent ends at a leaf that every
    restart mode reads, so an interior was read by a root descent iff its
    subtree holds a marked node: the closure's fixpoint, reached after one
    pass per tree level (extra passes change nothing). Leaf values and
    nonzero interiors are kept. Returns a new tensor (``visits`` itself
    for 0 passes). On a CUDA device this
    launches kernel K6 once per pass; on the CPU it is
    ``propagate_visits_plain``."""
    dev = words.device
    kernels.check(words, "words", _I32, (None,), dev)
    kernels.check(visits, "visits", _I32, (words.shape[0],), dev)
    if not kernels.uses_kernel(dev):
        return propagate_visits_plain(words, visits, passes)
    n = words.shape[0]
    bufs = (torch.empty_like(visits), torch.empty_like(visits))
    v = visits
    for p in range(passes):
        out = bufs[p % 2]
        kernels.launch("propagate_visits", "ot_propagate_visits", dev,
                       kernels.ptr(words), n, kernels.ptr(v), kernels.ptr(out))
        v = out
    return v


def apply_patches(words: torch.Tensor, idx, vals) -> torch.Tensor:
    """``words`` with the host patches applied: ``words[idx] = vals`` for
    ``idx >= 0``, ``vals`` as u32. Returns a new tensor, so a frame's pool
    snapshot stays as it was rendered (the JAX arrays are immutable too)."""
    idx = np.asarray(idx, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.uint32)
    keep = idx >= 0
    out = words.clone()
    out[torch.from_numpy(idx[keep]).to(words.device)] = u32_to_device(
        vals[keep], words.device)
    return out


def pad_patches(idx, vals, buckets=(256, 4096, 65536, 1048576)):
    """(idx, vals) padded to the next bucket size with idx -1 and value 0,
    as host NumPy arrays, as JAX's ``pad_patches`` (feedback.py:151) pads
    them so that its patch scatter compiles a bounded number of shapes; a
    patch past the last bucket raises. ``apply_patches`` drops the -1
    entries."""
    n = idx.shape[0]
    for b in buckets:
        if n <= b:
            pidx = np.full(b, -1, dtype=np.int32)
            pvals = np.zeros(b, dtype=np.uint32)
            pidx[:n] = idx
            pvals[:n] = vals
            return pidx, pvals
    raise ValueError(f"patch of {n} words exceeds largest bucket {buckets[-1]}")
