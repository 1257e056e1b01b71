"""Octree traversal, table build, shading and the frame.

The port of the JAX package's ``render/tracer.py`` main path. Each kernel
has a wrapper and, beside it, a plain PyTorch version of the same function
written as separate ops, term by term after the JAX expressions:

- ``trace`` (K1, ``csrc/trace.cu``) / ``trace_plain``: the semantics of JAX
  ``trace`` (``tracer.py:135``) in both restart forms (``parent_restart``),
  and ``trace_shadow`` (K1's shadow mode) / ``shadow_rays`` +
  ``trace_plain``: the frame's shadow pass;
- ``warp_occupancy`` (K2, ``csrc/warp_occupancy.cu``) /
  ``warp_occupancy_plain``: ``build_warp_table`` (``tracer.py:2859``) and
  ``skip.occupancy_from_pool`` (``skip.py:66``) from one descent, and
  ``k2_bytes``, the bytes it must move;
- ``shade`` (K4, ``csrc/shade_encode.cu``) / ``shade_plain`` and
  ``encode_u8_plain``: ``shade`` (``tracer.py:3132``) and ``encode_u8``
  (``:3191``); ``encode_u8`` encodes an image apart from the shading.

A wrapper runs the plain version only for tensors on the CPU; on a CUDA
device it launches its kernel or raises.

Both traversals read the pool as JAX's row gather does (``_row_read``):
word ``child`` of row ``min(node // 8, rows - 1)`` of the pool padded with
zeros to whole rows, so a malformed pool's pointer past the end gives
JAX's result.

``trace``, ``trace_shadow`` and ``render_frame`` take JAX's ``bricks`` and
``brick_k`` (K1's brick mode over ``bricks.build_bricks``'s table, K10) and
``paged`` (a ``paging.build_pages`` relayout, traced by K1 as it is;
``render_frame`` maps hit slots back with ``paged_old_of_new``).

JAX's frame schedules and ray orders:

- ``beam_start`` (K11, ``csrc/beam_start.cu``) / ``beam_start_plain``:
  ``beam_start`` (``tracer.py:2987``), each tile's common ancestor as the
  start of its rays' first descent, which ``trace(start=...)`` (K1's start
  forms) takes;
- ``render_frame``'s ``mode`` (``"tiled"``, ``"staged"`` or ``"beam"``,
  JAX's checks and errors), ``beams``, ``pre_permuted`` and ``raw_result``
  (rays and results in the block order of ``_pixel_to_block`` /
  ``_block_to_pixel``, ``tracer.py:1134-1172``; K4 writes the image in
  pixel order), ``warp_in_body``, and JAX's tuning knobs, validated;
  ``mode=None`` (the default) is the port's own frame, as before;
- ``trace_staged`` (``tracer.py:1477``), JAX's tuple from one ``trace``;
- ``fast_ranks``, ``fast_nonzero`` (``:69``, ``:85``) and the pool-size
  constants ``BIG_POOL_WORDS`` and ``PACK_POOL_WORDS``.

JAX's staged, beam and tiled schedules order the same per-ray loop, which
its own contract holds bit-identical to ``trace`` on hits; one traversal
kernel gives their results, in the order the caller asked for.

Pool words, table words and ``TraceResult.word`` are int32 tensors holding
u32 bits (see ``state.py``).
"""

from __future__ import annotations

import operator
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core.voxel import VOXEL_OFFSET
from ..state import div_scalar, narrow_u32, widen_u32
from ..utils import timing
from .skip import decode_skip

MAX_STEPS = 100
# JAX's pool-size thresholds for its TPU schedules (tracer.py:40, :45): the
# big-pool row-gather rate and the pack9 row layout. The port's kernel reads
# the pool one way at every size; the names are kept for JAX's callers.
BIG_POOL_WORDS = 1 << 22
PACK_POOL_WORDS = 1 << 20
_EPS_DIR = 1e-6
_EPS_NUDGE = 2e-6
_EPS_SHADOW = 2.5e-6
DEFAULT_SUN = (-1.7, -1.0, 0.8)

_F32, _I32 = torch.float32, torch.int32


class TraceResult(NamedTuple):
    hit: torch.Tensor      # bool[N]
    forced: torch.Tensor   # bool[N]: hits forced by the step cap
    index: torch.Tensor    # int32[N]: node slot of the hit leaf, -1 otherwise
    hit_pos: torch.Tensor  # f32[N, 3]
    normal: torch.Tensor   # f32[N, 3]
    steps: torch.Tensor    # int32[N]
    depth: torch.Tensor    # int32[N]
    word: torch.Tensor     # int32[N] of u32 bits: the hit leaf's pool word,
    #                        0 on a miss or a forced hit.


def fast_ranks(mask: torch.Tensor) -> torch.Tensor:
    """int32[N]: the inclusive count of true elements up to each element,
    less one, so each true element's position among the trues (JAX
    ``fast_ranks``, tracer.py:69, which takes it by a blocked two-level
    cumsum; the values are the same)."""
    return (torch.cumsum(mask.reshape(-1).to(torch.int64), 0) - 1).to(_I32)


def fast_nonzero(mask: torch.Tensor, size: int, fill_value: int,
                 ranks: torch.Tensor | None = None) -> torch.Tensor:
    """int32[size]: the indices of the first ``size`` true elements of
    ``mask`` in order, then ``fill_value`` (JAX ``fast_nonzero``,
    tracer.py:85); ``ranks`` may be a caller's ``fast_ranks(mask)``."""
    mask = mask.reshape(-1).to(torch.bool)
    if ranks is None:
        ranks = fast_ranks(mask)
    out = torch.full((size,), fill_value, dtype=_I32, device=mask.device)
    take = mask & (ranks < size)
    # JAX's scatter takes a negative target from the end, as NumPy does.
    tgt = ranks[take].long()
    tgt = torch.where(tgt < 0, tgt + size, tgt)
    src = torch.nonzero(take).flatten().to(_I32)
    out[tgt[tgt >= 0]] = src[tgt >= 0]
    return out


def _block_perm(h: int, w: int, block: int, morton: bool):
    """The view shape and axis order that take a flat [h*w] pixel-order
    axis to block order (JAX ``_pixel_to_block``, tracer.py:1134): each
    ``block`` x ``block`` tile's pixels contiguous, row-major within the
    tile, or under ``morton`` in interleaved-bit order, pixel (y, x) at
    offset y_k x_k ... y_0 x_0."""
    if block < 1 or h % block or w % block:
        raise ValueError(f"block {block} must divide {h}x{w}")
    hb, wb = h // block, w // block
    if not morton:
        return (hb, block, wb, block), [0, 2, 1, 3]
    lv = block.bit_length() - 1
    if block != 1 << lv:
        raise ValueError(f"a Morton block order needs a power-of-two block, got {block}")
    perm = [0, lv + 1]
    for k in range(lv):
        perm += [1 + k, lv + 2 + k]
    return (hb,) + (2,) * lv + (wb,) + (2,) * lv, perm


def _pixel_to_block(x: torch.Tensor, h: int, w: int, block: int,
                    morton: bool = False) -> torch.Tensor:
    """``x`` (flat [h*w, ...] in pixel order) in block order; the inverse
    is ``_block_to_pixel``."""
    shape, perm = _block_perm(h, w, block, morton)
    rest = tuple(x.shape[1:])
    t = x.reshape(shape + rest).permute(perm + list(range(len(shape), len(shape) + len(rest))))
    return t.reshape((h * w,) + rest)


def _block_to_pixel(x: torch.Tensor, h: int, w: int, block: int,
                    morton: bool = False) -> torch.Tensor:
    """``x`` (flat [h*w, ...] in ``_pixel_to_block`` order) in pixel order."""
    shape, perm = _block_perm(h, w, block, morton)
    rest = tuple(x.shape[1:])
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    t = x.reshape(tuple(shape[p] for p in perm) + rest)
    t = t.permute(inv + list(range(len(shape), len(shape) + len(rest))))
    return t.reshape((h * w,) + rest)


def warp_table_levels(warp_table) -> int:
    """Levels L of a warp table (8^L words) or combined table (2*8^L)."""
    n = int(warp_table.shape[0])
    lv = max((n.bit_length() - 1) // 3, 0)
    if (1 << (3 * lv)) == n or (1 << (3 * lv + 1)) == n:
        return lv
    raise ValueError(f"not a warp-table length (8^levels or 2*8^levels): {n}")


def warp_table_combined(warp_table) -> bool:
    """True for a combined (warp, skip) table of 2*8^L words."""
    return int(warp_table.shape[0]) == 2 * (1 << (3 * warp_table_levels(warp_table)))


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as f32 for e <= 127, built from its bits: exact for every
    e >= -149 (subnormal below -126), 0 below. A descent through a pool
    whose pointers cycle can pass 126 levels; past there the plain
    exponent field would wrap to -inf and then NaN."""
    e = e.to(_I32)
    normal = (e.clamp(min=-126) + 127) << 23
    subnormal = 1 << (e.clamp(-149, -127) + 149)
    return torch.where(e >= -126, normal,
                       torch.where(e >= -149, subnormal, 0)).view(_F32)


def _in_bounds(v: torch.Tensor) -> torch.Tensor:
    return torch.all((v >= -1.0) & (v < 1.0), dim=-1)


def _ray_box_dist(pos: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Slab entry distance to the root cube, 0 == miss."""
    t1 = (-1.0 - pos) / dirs
    t2 = (1.0 - pos) / dirs
    v7 = torch.minimum(t1, t2).amax(dim=-1)
    v8 = torch.maximum(t1, t2).amin(dim=-1)
    return torch.where((v8 < 0.0) | (v7 > v8), torch.zeros_like(v7), v7)


def _decode_skip(skip_word: torch.Tensor, oct_: torch.Tensor) -> torch.Tensor:
    """The cube side stored in ``skip_word`` for octant ``oct_``."""
    return decode_skip((skip_word >> (4 * oct_)) & 15)


def _warp_lookup(table: torch.Tensor, levels: int, p: torch.Tensor,
                 strict: bool, combined: bool):
    """JAX ``_warp_lookup`` (tracer.py:2916) on a widened table: returns
    (index, centre f32[m, 3], depth, valid, skip word or None)."""
    side = 1 << levels
    cells = torch.floor((p + 1.0) * (side / 2.0)).clamp(0, side - 1).long()
    flat = (cells[:, 0] * side + cells[:, 1]) * side + cells[:, 2]
    lane = flat * 2 if combined else flat
    packed = table[lane]
    skip = table[lane + 1] if combined else None
    w_index = packed >> 5
    w_depth = packed & 31
    anc = cells >> (levels - w_depth).clamp(min=0)[:, None]
    scale = _pow2(w_depth)[:, None]
    centre = (anc.to(_F32) * 2.0 + 1.0) / scale - 1.0
    half = 1.0 / scale
    if strict:
        in_cell = torch.all((p > centre - half) & (p <= centre + half), dim=-1)
    else:
        in_cell = torch.all((p >= centre - half) & (p < centre + half), dim=-1)
    valid = in_cell & (w_depth > 0)
    return (
        torch.where(valid, w_index, 0),
        torch.where(valid[:, None], centre, 0.0),
        torch.where(valid, w_depth, 0),
        valid,
        skip,
    )


def _cell_slots(table: torch.Tensor, levels: int, pool: torch.Tensor,
                cells: torch.Tensor) -> torch.Tensor:
    """The covering slot of each cell (int64[m, 3] grid coordinates) of a
    combined table: from a stored node (depth > 0), its child toward the
    cell's centre; from a word of depth 0 (the root's, or one the Session
    zeroed), the slot that the table build's descent toward the centre
    (``_k2_descent``) reads last. In an empty cell both are the empty leaf
    that covers it, which a root descent through the cell reads."""
    side = 1 << levels
    flat = (cells[:, 0] * side + cells[:, 1]) * side + cells[:, 2]
    centre = (cells.to(_F32) + 0.5) * (2.0 / side) - 1.0
    packed = table[flat * 2]
    w_depth = packed & 31
    anc = cells >> (levels - w_depth).clamp(min=0)[:, None]
    w_centre = (anc.to(_F32) * 2.0 + 1.0) * _pow2(-w_depth)[:, None] - 1.0
    pb = centre > w_centre
    slot = (packed >> 5) + pb[:, 0].long() * 4 + pb[:, 1].long() * 2 + pb[:, 2].long()
    root = torch.nonzero(w_depth == 0).squeeze(1)
    if root.numel():
        c = centre[root]
        node = torch.zeros_like(root)
        node_pos = torch.zeros_like(c)
        last = node
        for it in range(levels):
            pb = c > node_pos
            child = pb[:, 0].long() * 4 + pb[:, 1].long() * 2 + pb[:, 2].long()
            last = node + child
            payload = pool[_row_read(pool, node, child)] >> 4
            down = payload < VOXEL_OFFSET
            step = (pb.to(_F32) * 2.0 - 1.0) * 0.5 ** (it + 1)
            node_pos = torch.where(down[:, None], node_pos + step, node_pos)
            node = torch.where(down, payload, node)
        slot[root] = last
    return slot


def _jump_walk(table: torch.Tensor, levels: int, pool: torch.Tensor, p, d, rs, v, skw,
               leaf_c, leaf_h, leaf_slot, strict: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The walk of K1's ``mark_jump`` over every jumping ray at once: the
    slots a counted jump marks and the steps it stands for (both returned
    by ``_jump_slots``), for rays that take one from position ``v`` (entry
    ``p``, direction ``d``, signs ``rs``) across the cube of ``skw`` cells
    anchored at ``v``'s cell, out of the empty leaf of slot ``leaf_slot``,
    centre ``leaf_c`` and half side ``leaf_h``.

    A root descent through the jumped segment reads, in every cell it
    crosses, the empty leaf that covers the cell (the cube holds no node
    below the table's level) and that leaf's ancestors, and takes one
    boundary step out of each such leaf. From the cell that holds ``v``
    under the descent's boundary rule (``strict``: (lo, hi]), which the
    cube's anchor, ``v``'s cell by its floor, may miss on a face, the walk
    steps from cell to cell by the exit planes of each cell, (plane - p) /
    d as the jump's own planes, every tied axis at once, until it leaves
    the cube (a step at or past the jump's exit, the cube's planes being
    cells' planes) or the grid. It marks the covering slot
    (``_cell_slots``) of each cell entered outside the leaf; the visit
    closure then marks the ancestors. Each cell entered whose covering slot
    differs from the one before (the leaf's, at the start), the first cell
    past the cube included (outside the grid is no slot), is one of the
    root descent's steps: int64[m] of them a ray, at least 1."""
    side = 1 << levels
    cw = 2.0 / side
    c = torch.floor((v + 1.0) * (side / 2.0)).clamp(0, side - 1)
    clo = c * cw - 1.0
    skb = skw.to(_F32)[:, None]
    exit_t = ((torch.where(rs > 0, clo + skb * cw, (clo + cw) - skb * cw) - p) / d).amin(dim=1)
    c = c.long()
    s = torch.where(rs > 0, 1, -1)
    below = (v <= clo) if strict else (v < clo)
    above = (v > clo + cw) if strict else (v >= clo + cw)
    c = c - (below & (c > 0)).long() + (above & (c < side - 1)).long()
    live = torch.ones_like(skw, dtype=torch.bool)
    prev = leaf_slot.clone()
    n = torch.zeros_like(skw)
    marked = []
    for it in range(3 * int(skw.max())):
        clo = c.to(_F32) * cw - 1.0
        tt = (torch.where(rs > 0, clo + cw, clo) - p) / d
        tm = tt.amin(dim=1, keepdim=True)
        c = c + s * (tt <= tm)
        in_grid = torch.all((c >= 0) & (c < side), dim=1)
        in_cube = (it < 3 * skw) & (tm[:, 0] < exit_t) & in_grid
        on = live & in_cube
        land = live & ~in_cube & in_grid
        cc = (c.to(_F32) + 0.5) * cw - 1.0
        in_leaf = torch.all((cc > leaf_c - leaf_h) & (cc < leaf_c + leaf_h), dim=1)
        slot = torch.where(on & in_leaf, prev, -1)
        look = torch.nonzero((on & ~in_leaf) | land).squeeze(1)
        slot[look] = _cell_slots(table, levels, pool, c[look])
        n += live & (slot != prev)
        marked.append(slot[on & ~in_leaf])
        prev = slot
        live = on
        if not bool(live.any()):
            break
    return (torch.cat(marked) if marked else c.new_zeros(0)), n


def _jump_slots(table: torch.Tensor, levels: int, pool: torch.Tensor, p, d, rs, v, skw,
                leaf_c, leaf_h, strict: bool = True, leaf_slot: torch.Tensor | None = None,
                steps: torch.Tensor | None = None) -> torch.Tensor:
    """The slots a counted skip jump marks, from one ``_jump_walk`` out of
    the leaf of slot ``leaf_slot`` (none by default; the marks do not read
    it); the root descent's steps the jump stands for go into ``steps``
    when one is given."""
    if leaf_slot is None:
        leaf_slot = torch.full_like(skw, -1)
    slots, n = _jump_walk(table, levels, pool, p, d, rs, v, skw, leaf_c, leaf_h, leaf_slot,
                          strict)
    if steps is not None:
        steps.copy_(n)
    return slots


def _pool_rows(words: torch.Tensor) -> torch.Tensor:
    """The pool's words widened (``widen_u32``) and padded with zero words
    to whole 8-word rows, as JAX pads the pool before its row gathers
    (tracer.py:399-402, :2882-2884; skip.py:88-90)."""
    pool = widen_u32(words)
    pad = (-pool.shape[0]) % 8
    return torch.cat([pool, pool.new_zeros(pad)]) if pad else pool


def _row_read(pool: torch.Tensor, node: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """Index into ``_pool_rows``'s pool of the word that JAX's row gather
    reads for child ``child`` of node ``node``: word ``child`` of row
    ``min(node // 8, rows - 1)``. XLA's gather clamps the row, not the word,
    so a pointer past the pool's end reads the last row, and a word of the
    last row past the pool's end reads 0."""
    return (torch.clamp(node >> 3, max=pool.shape[0] // 8 - 1) << 3) | child


def _check_pool(words: torch.Tensor) -> None:
    if words.shape[0] == 0:
        raise ValueError("the pool is empty: it must hold at least the root group")


def _max_iters(max_steps: int, max_iters: int | None) -> int:
    """The loop's trip cap: ``max_iters``, or JAX's ``(max_steps + 2) * 26``
    when None (tracer.py:201-202)."""
    if max_iters is None:
        return (max_steps + 2) * 26
    if not 0 <= max_iters < 1 << 31:
        raise ValueError(f"max_iters must be in [0, 2^31), got {max_iters}")
    return int(max_iters)


def _check_modes(words, warp_table, bricks, paged, fuse_sibling=False) -> None:
    """JAX's exclusions (tracer.py:420-426), ``paged``'s geometry against
    the pool's length, and the brick table's shape."""
    if paged is not None:
        if bricks is not None or warp_table is not None or fuse_sibling:
            raise ValueError("paged excludes bricks/warp_table/fuse_sibling")
        if len(paged) != 3 or not all(isinstance(x, int) and x >= 1 for x in paged):
            raise ValueError(f"paged must be (top_rows, page_rows, n_pages) ints >= 1, "
                             f"got {paged}")
        top_rows, page_rows, n_pages = paged
        if (top_rows + page_rows * n_pages) * 8 != words.shape[0]:
            raise ValueError(f"paged geometry {paged} holds "
                             f"{(top_rows + page_rows * n_pages) * 8} words, the pool "
                             f"{words.shape[0]}")
    if bricks is not None:
        if warp_table is not None or fuse_sibling:
            raise ValueError("bricks exclude warp_table/fuse_sibling")
        kernels.check(bricks, "bricks", _I32, (words.shape[0], 8), words.device)


def _check_start(start, n: int, dev) -> None:
    """``start`` as JAX's ``_init_state`` takes it (tracer.py:239-290): a
    triple (node index int32[n], node centre f32[n, 3], depth int32[n])."""
    if not isinstance(start, (tuple, list)) or len(start) != 3:
        raise TypeError("start must be (node_index, node_pos, depth)")
    kernels.check(start[0], "start node_index", _I32, (n,), dev)
    kernels.check(start[1], "start node_pos", _F32, (n, 3), dev)
    kernels.check(start[2], "start depth", _I32, (n,), dev)


def _check_warp_levels(warp_table, warp_levels) -> None:
    """JAX takes ``warp_levels`` beside the table and indexes the table by
    it; the port reads the levels from the table's length, and a
    ``warp_levels`` that differs from them, which would misindex JAX's
    table, raises."""
    if warp_table is not None and warp_levels is not None:
        levels = warp_table_levels(warp_table)
        if warp_levels != levels:
            raise ValueError(f"warp_levels {warp_levels} differs from the table's "
                             f"{levels} levels")


def _brick_read(pool, bt, node, child):
    """The word JAX's brick mode reads for child ``child`` of ``node``: its
    one table of the pool's rows, then the brick rows (tracer.py:430), with
    the row clamped into that table, so a pointer past the pool's end reads
    a brick row, the last one at most."""
    r = node >> 3
    rows = pool.shape[0] // 8
    brick = bt[(r - rows).clamp(0, bt.shape[0] - 1), child]
    return torch.where(r < rows, pool[_row_read(pool, node, child)], brick)


def _warp_start(warp_table, origins, dirs, strict: bool):
    """The start of each ray's first descent that JAX's ``_init_state``
    looks up in the table at the ray's entry point (tracer.py:263-282):
    (node int32[N], centre f32[N, 3], depth int32[N]), the root where the
    cell's stored node does not hold the point."""
    entry, _ = _entry_points(origins, dirs)
    node, cp, depth, _, _ = _warp_lookup(
        widen_u32(warp_table), warp_table_levels(warp_table), entry, strict,
        warp_table_combined(warp_table))
    return node.to(_I32), cp.contiguous(), depth.to(_I32)


def trace_plain(words, origins, dirs, active_init=None, max_steps=MAX_STEPS,
                strict_descent=True, warp_table=None, visits=None,
                visit_flags=False, parent_restart=True,
                max_iters=None, bricks=None, brick_k=4, paged=None,
                start=None, warp_in_body=True) -> TraceResult:
    """Plain PyTorch version of kernel K1: JAX ``trace``, iterated over the
    rays still active.

    Each loop trip is one JAX ``_make_body`` iteration for every live ray;
    finished rays leave the working set, which changes no ray's result. A
    ray still active after ``max_iters`` trips (by default ``(max_steps +
    2) * 26``) stays unresolved. ``parent_restart=False`` restarts every
    boundary step at the warp cell or the root, never at the parent: the
    reference's full re-descent, whose visit counts are the oracle's.
    ``visits`` (int32[pool], updated in place) gets one mark at the slot
    each trip reads, as JAX ``_visit_mark`` (tracer.py:355): a count, or a
    1 under ``visit_flags``. ``bricks`` runs JAX's brick DDA
    (``_brick_substeps``, tracer.py:832), ``paged`` checks the geometry of
    a relayouted pool, ``start`` sets each ray's first descent, and
    ``warp_in_body=False`` reads the table for first descents only
    (``trace`` says more of each)."""
    _check_modes(words, warp_table, bricks, paged)
    if warp_table is not None and not warp_in_body:
        if start is None:
            start = _warp_start(warp_table, origins, dirs, strict_descent)
        warp_table = None
    dev = dirs.device
    n = dirs.shape[0]
    n_words = words.shape[0]
    pool = _pool_rows(words)
    table = widen_u32(warp_table) if warp_table is not None else None
    bt = widen_u32(bricks) if bricks is not None else None
    levels = warp_table_levels(warp_table) if table is not None else 0
    combined = table is not None and warp_table_combined(warp_table)
    side = 1 << levels

    o = origins.to(_F32)
    d = dirs.to(_F32)
    d = torch.where(d == 0.0, _EPS_DIR, d)
    inside = _in_bounds(o)
    dist = _ray_box_dist(o, d)
    active = inside | (dist != 0.0)
    if active_init is not None:
        active = active & active_init
    pos = torch.where(inside[:, None], o, o + d * dist[:, None])

    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    forced = torch.zeros(n, dtype=torch.bool, device=dev)
    index = torch.full((n,), -1, dtype=_I32, device=dev)
    hit_pos = torch.zeros((n, 3), dtype=_F32, device=dev)
    normal = torch.zeros((n, 3), dtype=_F32, device=dev)
    out_steps = torch.zeros(n, dtype=_I32, device=dev)
    out_depth = torch.zeros(n, dtype=_I32, device=dev)
    out_word = torch.zeros(n, dtype=torch.int64, device=dev)
    outs = {"hit": hit, "forced": forced, "index": index, "hit_pos": hit_pos,
            "normal": normal, "steps": out_steps, "depth": out_depth}

    def mark(slots):
        marked = slots[(slots >= 0) & (slots < n_words)]  # others drop, as JAX's
        if visit_flags:
            visits[marked] = 1
        else:
            visits.index_add_(0, marked, torch.ones_like(marked, dtype=_I32))

    # Working set: the live rays' state (ids index the outputs); bm: in
    # brick mode, where node is the brick root's slot.
    ids = torch.nonzero(active).squeeze(1)
    p = pos[ids]            # entry position = origin of every boundary step
    d = d[ids]
    v = p.clone()
    nrm = torch.trunc(p * 1.000001)
    rs = torch.sign(d)
    oct_ = (d[:, 0] > 0).long() * 4 + (d[:, 1] > 0).long() * 2 + (d[:, 2] > 0).long()
    m = ids.shape[0]
    node = torch.zeros(m, dtype=torch.int64, device=dev)
    cp = torch.zeros((m, 3), dtype=_F32, device=dev)
    depth = torch.zeros(m, dtype=torch.int64, device=dev)
    steps = torch.zeros(m, dtype=torch.int64, device=dev)
    skw = torch.zeros(m, dtype=torch.int64, device=dev)
    bm = torch.zeros(m, dtype=torch.bool, device=dev)
    if start is not None:  # it wins over the table, whose skip side starts at 0
        node = start[0][ids].long()
        cp = start[1][ids].to(_F32)
        depth = start[2][ids].long()
    elif table is not None:
        node, cp, depth, _, skip = _warp_lookup(table, levels, p, strict_descent,
                                                combined)
        if combined:
            skw = _decode_skip(skip, oct_)

    for _ in range(_max_iters(max_steps, max_iters)):
        if ids.shape[0] == 0:
            break
        # The brick lanes' trip, from the trip's starting state.
        bi = torch.nonzero(bm).squeeze(1) if bt is not None else None
        if bi is not None and bi.numel():
            # The slot's row; the last past the table's end (or below 0, as
            # the kernel's unsigned clamp).
            brow = torch.where(node[bi] >= 0, node[bi].clamp(max=n_words - 1), n_words - 1)
            b = _brick_substeps(
                bt[brow], node[bi], cp[bi], depth[bi], v[bi], nrm[bi], steps[bi],
                p[bi], d[bi], rs[bi], strict_descent, max_steps, brick_k,
                mark if visits is not None else None)
            r = ids[bi]
            for mask, fields in b["records"]:
                for name, val in fields.items():
                    dst = outs[name]
                    dst[r[mask]] = val[mask].to(dst.dtype) if torch.is_tensor(val) else val

        depth1 = depth + 1
        pb = v > cp if strict_descent else v >= cp
        child = pb[:, 0].long() * 4 + pb[:, 1].long() * 2 + pb[:, 2].long()
        inv1 = _pow2(-depth1)[:, None]
        np_ = cp + (pb.to(_F32) * 2.0 - 1.0) * inv1
        idx = node + child
        a = ~bm if bt is not None else None
        if bt is None:
            word = pool[_row_read(pool, node, child)]
        else:
            word = _brick_read(pool, bt, node, child)
        if visits is not None:
            mark(idx if a is None else idx[a])
        payload = word >> 4
        leaf = payload >= VOXEL_OFFSET
        filled = payload > VOXEL_OFFSET
        hit_now = leaf & filled
        interior = ~leaf
        stepping = leaf & ~filled
        if a is not None:
            hit_now, interior, stepping = hit_now & a, interior & a, stepping & a

        # Boundary step (used by the stepping rays); `taken`: the steps each
        # stands for, one but for a counted jump's.
        t = ((np_ - p) + rs * inv1) / d
        taken = torch.ones_like(steps)
        if combined:
            side_j = skw
            if visits is not None:
                # A counted jump stands for a root descent's steps across it,
                # at most 3 * side - 2: its cube shrinks near the step cap, so
                # that the cap falls where the descent's does.
                side_j = torch.minimum(skw, torch.div(max_steps - steps + 2, 3,
                                                      rounding_mode="floor"))
            skb = side_j.to(_F32)[:, None]
            cw = 2.0 / side
            ci = torch.floor((v + 1.0) * (side / 2.0)).clamp(0, side - 1)
            clo = ci * cw - 1.0
            plane = torch.where(rs > 0, clo + skb * cw, (clo + cw) - skb * cw)
            st = (plane - p) / d
            sk_use = (side_j > 0) & (st.amin(dim=1) > t.amin(dim=1))
            t = torch.where(sk_use[:, None], st, t)
            jump = sk_use & stepping
            if visits is not None and bool(jump.any()):
                walk = (table, levels, pool, p[jump], d[jump], rs[jump], v[jump],
                        side_j[jump], np_[jump], inv1[jump])
                # One step a jump stays where the walk writes none.
                taken_j = torch.ones_like(side_j[jump])
                mark(_jump_slots(*walk, strict=strict_descent, leaf_slot=idx[jump],
                                 steps=taken_j))
                taken[jump] = taken_j
        tx, ty, tz = t.unbind(1)
        face = torch.stack([tx <= torch.minimum(ty, tz),
                            ty <= torch.minimum(tz, tx),
                            tz <= torch.minimum(tx, ty)], dim=1)
        nn = face.to(_F32) * -rs
        t_cur = torch.minimum(torch.minimum(tx, ty), tz)
        nv = (p + d * t_cur[:, None]) - nn * _EPS_NUDGE
        inb = _in_bounds(nv)
        oob = stepping & ~inb
        steps_new = steps + taken
        over = stepping & inb & (steps_new > max_steps)
        go = stepping & inb & ~over

        r = ids[hit_now]
        hit[r] = True
        index[r] = idx[hit_now].to(_I32)
        out_word[r] = word[hit_now]
        hit_pos[r] = v[hit_now]
        normal[r] = nrm[hit_now]
        out_steps[r] = steps[hit_now].to(_I32)
        out_depth[r] = depth1[hit_now].to(_I32)
        r = ids[oob]
        out_steps[r] = (steps_new[oob] - 1).to(_I32)
        out_depth[r] = depth1[oob].to(_I32)
        r = ids[over]
        hit[r] = True
        forced[r] = True
        hit_pos[r] = nv[over]
        normal[r] = nn[over]
        out_steps[r] = steps_new[over].to(_I32)
        out_depth[r] = max_steps

        # Restart: parent when the stepped position stays in the leaf's
        # parent cell (under parent_restart), else the warp cell's node,
        # else the root.
        go_root = go
        if parent_restart:
            vs = 2.0 * inv1
            if strict_descent:
                in_parent = torch.all((nv > cp - vs) & (nv <= cp + vs), dim=1)
            else:
                in_parent = torch.all((nv >= cp - vs) & (nv < cp + vs), dim=1)
            go_root = go & ~in_parent
        # interior, go & in_parent (all unchanged), go_warp and go_root are
        # disjoint, so their updates apply one after another.
        if table is not None:
            w_i, w_p, w_d, w_valid, w_skip = _warp_lookup(
                table, levels, nv, strict_descent, combined
            )
            go_warp = go_root & w_valid
            go_root = go_root & ~w_valid
            node = torch.where(go_warp, w_i, node)
            cp = torch.where(go_warp[:, None], w_p, cp)
            depth = torch.where(go_warp, w_d, depth)
            if combined:
                skw = torch.where(go, _decode_skip(w_skip, oct_), skw)
        # A descent into a decorated node enters brick mode at that slot.
        enter_b = interior & ((word & 1) != 0) if bt is not None else None
        target = payload if bt is None else torch.where(enter_b, idx, payload)
        node = torch.where(interior, target, torch.where(go_root, 0, node))
        cp = torch.where(interior[:, None], np_,
                         torch.where(go_root[:, None], 0.0, cp))
        depth = torch.where(interior, depth1, torch.where(go_root, 0, depth))
        v = torch.where(go[:, None], nv, v)
        nrm = torch.where(go[:, None], nn, nrm)
        steps = torch.where(go, steps_new, steps)

        keep = interior | go
        if bt is not None:
            bm = enter_b
            if bi.numel():
                v[bi], nrm[bi], steps[bi] = b["v"], b["nrm"], b["steps"]
                node[bi], cp[bi], depth[bi] = b["node"], b["cp"], b["depth"]
                bm[bi] = b["bmode"]
                keep[bi] = b["alive"]
        ids, p, d, v, nrm, rs, oct_ = (
            x[keep] for x in (ids, p, d, v, nrm, rs, oct_))
        node, cp, depth, steps, skw, bm = (
            x[keep] for x in (node, cp, depth, steps, skw, bm))

    if bt is not None:  # `_refetch_words` (tracer.py:318): the word at index
        slot = index.clamp(min=0).long()
        out_word = torch.where(hit & ~forced, pool[_row_read(pool, slot, slot & 7)], 0)
    return TraceResult(hit, forced, index, hit_pos, normal, out_steps,
                       out_depth, narrow_u32(out_word))


def _brick_substeps(rows, slot, c, db, v, nrm, steps, p, d, rs, strict, max_steps,
                    brick_k, mark):
    """JAX ``_brick_substeps`` (tracer.py:832) for the lanes in brick mode:
    up to ``brick_k`` sub-steps of the DDA over each lane's brick row
    ``rows`` (int64 [m, 8]) at brick root ``slot``, cell ``c`` and depth
    ``db``, from position ``v``. Returns the lanes' new state (``v``,
    ``nrm``, ``steps``, ``node``, ``cp``, ``depth``, ``bmode``, ``alive``)
    and ``records``: (lane mask, result fields) of the lanes that finished,
    in order. ``mark(slots)``, if given, marks each sub-step's visits."""
    w0, occ_lo, occ_hi, cgroup = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    cgroup = torch.where(cgroup >= 1 << 31, cgroup - (1 << 32), cgroup)  # int32, as JAX
    h = _pow2(-db)[:, None]
    q1, q2 = h * 0.5, h * 0.25
    m = slot.shape[0]
    inst = torch.ones(m, dtype=torch.bool, device=slot.device)
    done = torch.zeros_like(inst)
    desc = torch.zeros_like(inst)
    par = torch.zeros_like(inst)
    root = torch.zeros_like(inst)
    d_idx = torch.zeros_like(slot)
    d_c = torch.zeros_like(c)
    code = slot & 7
    bits = torch.stack([(code >> 2) & 1, (code >> 1) & 1, code & 1], dim=1).to(_F32)
    pc = c - (bits * 2.0 - 1.0) * h
    h2 = h * 2.0
    records = []
    for _ in range(brick_k):
        if not bool(inst.any()):
            break
        b1 = v > c if strict else v >= c
        m1 = c + (b1.to(_F32) * 2.0 - 1.0) * q1
        b2 = v > m1 if strict else v >= m1
        m2 = m1 + (b2.to(_F32) * 2.0 - 1.0) * q2
        ccode = b1[:, 0].long() * 4 + b1[:, 1].long() * 2 + b1[:, 2].long()
        bit = ccode * 8 + b2[:, 0].long() * 4 + b2[:, 1].long() * 2 + b2[:, 2].long()
        occ = ((torch.where(bit < 32, occ_lo, occ_hi) >> (bit & 31)) & 1) != 0
        cl = ((w0 >> (ccode + 1)) & 1) != 0
        tgt = cgroup + ccode
        if mark is not None:
            mark(tgt[inst])

        hitc = inst & occ & cl
        records.append((hitc, dict(hit=True, index=tgt, hit_pos=v, normal=nrm, steps=steps,
                                   depth=db + 1)))
        dsc = inst & occ & ~cl
        desc = desc | dsc
        d_idx = torch.where(dsc, tgt, d_idx)
        d_c = torch.where(dsc[:, None], m1, d_c)

        stepping = inst & ~occ
        ctr = torch.where(cl[:, None], m1, m2)
        half = torch.where(cl[:, None], q1, q2)
        t = ((ctr - p) + rs * half) / d
        tx, ty, tz = t.unbind(1)
        face = torch.stack([tx <= torch.minimum(ty, tz),
                            ty <= torch.minimum(tz, tx),
                            tz <= torch.minimum(tx, ty)], dim=1)
        nn = face.to(_F32) * -rs
        t_cur = torch.minimum(torch.minimum(tx, ty), tz)
        q = (p + d * t_cur[:, None]) - nn * _EPS_NUDGE
        inb = _in_bounds(q)
        oob = stepping & ~inb
        records.append((oob, dict(steps=steps, depth=db + torch.where(cl, 1, 2))))
        steps_new = steps + 1
        over = stepping & inb & (steps_new > max_steps)
        records.append((over, dict(hit=True, forced=True, hit_pos=q, normal=nn,
                                   steps=steps_new, depth=max_steps)))
        done = done | hitc | oob | over
        go = stepping & inb & ~over

        if strict:
            inc = torch.all((q > c - h) & (q <= c + h), dim=1)
            inp = torch.all((q > pc - h2) & (q <= pc + h2), dim=1)
        else:
            inc = torch.all((q >= c - h) & (q < c + h), dim=1)
            inp = torch.all((q >= pc - h2) & (q < pc + h2), dim=1)
        exit_b = go & ~inc
        par = par | (exit_b & inp)
        root = root | (exit_b & ~inp)
        v = torch.where(go[:, None], q, v)
        nrm = torch.where(go[:, None], nn, nrm)
        steps = torch.where(go, steps_new, steps)
        inst = go & inc

    return dict(
        v=v, nrm=nrm, steps=steps, records=records,
        node=torch.where(desc, d_idx, torch.where(par, slot & ~7,
                                                  torch.where(root, 0, slot))),
        cp=torch.where(desc[:, None], d_c, torch.where(par[:, None], pc,
                                                       torch.where(root[:, None], 0.0, c))),
        depth=torch.where(desc, db + 1, torch.where(par, db - 1, torch.where(root, 0, db))),
        bmode=inst | desc, alive=~done)


def _trace_checks(words, n, dev, warp_table, visits, visit_flags, bricks, paged,
                  fuse_sibling=False):
    """Checks shared by K1's two wrappers; returns (table_mode, levels,
    visit_mode)."""
    kernels.check(words, "words", _I32, (None,), dev)
    _check_pool(words)
    _check_modes(words, warp_table, bricks, paged, fuse_sibling)
    if bricks is not None and kernels.uses_kernel(dev) and bricks.data_ptr() % 16:
        raise ValueError("bricks must start on a 16-byte boundary")
    if 3 * n >= 1 << 31:
        raise ValueError(f"{n} rays: K1 indexes rays in int32, so n < 2^31 / 3")
    table_mode, levels = 0, 0
    if warp_table is not None:
        kernels.check(warp_table, "warp_table", _I32, (None,), dev)
        levels = warp_table_levels(warp_table)
        table_mode = 2 if warp_table_combined(warp_table) else 1
    visit_mode = 0
    if visits is not None:
        kernels.check(visits, "visits", _I32, (words.shape[0],), dev)
        visit_mode = 2 if visit_flags else 1
    return table_mode, levels, visit_mode


def trace(words, origins, dirs, active_init=None, max_steps=MAX_STEPS,
          strict_descent=True, warp_table=None, visits=None,
          visit_flags=False, parent_restart=True, max_iters=None, bricks=None,
          brick_k=4, paged=None, start=None, warp_levels=None, unroll=1,
          fuse_sibling=False, warp_in_body=True) -> TraceResult:
    """Trace the rays ``dirs`` through the node pool ``words``.

    ``dirs`` is f32[N, 3], or an image f32[H, W, 3] of N = H*W rays, which
    the kernel takes in tiles of 8x4 neighbouring pixels; results are flat
    [N] in pixel order either way. ``origins`` is f32[N, 3], or one point
    for every ray as an ``expand``ed view of stride (0, 1). ``active_init``
    an optional bool[N] mask of rays to trace at all, ``warp_table`` an
    optional warp table (8^L words) or combined warp+skip table (2*8^L
    words) of ``words``. ``visits``, an optional int32 tensor of the pool's
    length, is marked in place at every slot a ray reads: counted, or set to
    1 under ``visit_flags``; a skip jump of a combined table also marks the
    empty leaf that covers each table cell it crosses (``_jump_slots``),
    which a root descent reads there, so that the visit closure leaves a
    root descent's interior zero-set, and counts the boundary steps a root
    descent takes across it (the same walk), its cube shrinking near
    ``max_steps`` so that no jump crosses it: the counted ``steps`` and the
    rays forced at the cap are the trace's without the jumps. Uncounted, a
    jump counts one step, as in JAX. ``parent_restart=False`` takes the
    reference's full re-descent after every boundary step (from the warp
    cell where the table has one, else from the root), the only form whose
    visit counts have the reference counter's magnitudes; hits are the same
    in both forms. A ray still active after ``max_iters`` loop trips (by default
    ``(max_steps + 2) * 26``) stays unresolved.

    ``bricks``, the int32[pool, 8] table of ``bricks.build_bricks`` (then
    ``words`` must be the decorated pool from the same call), runs JAX's
    brick DDA: a ray that descends into a brick root marches its 4x4x4
    cells by arithmetic, ``brick_k`` sub-steps a loop trip, with results
    equal to the plain traversal's. A ray's trips then depend on
    ``brick_k``, so under an explicit ``max_iters`` the rays left
    unresolved are JAX's. A step out of a brick resumes from the brick
    root's parent cell, or the root, in either restart form (JAX's
    ``_brick_substeps`` never reads ``parent_restart``), so the root form
    with bricks lacks the reference's visit magnitudes. Bricks exclude
    ``warp_table``, as in JAX.

    ``paged`` = (top_rows, page_rows, n_pages) of a ``paging.build_pages``
    relayout whose ``words`` this is: results, in relayouted slots, are
    the unpaged traversal's, as JAX's paged trace's are (its page
    scheduling only stalls rays, and the relayout keeps the traversal's
    semantics); the traversal is the plain one, over the relayouted pool,
    under the unpaged cap, so every ray's result equals the unpaged
    trace's. JAX's cap counts the wavefront's trips, stalls included, and
    its default is ``n_pages * 32`` times the unpaged one, so that no ray
    is cut off by its stalls (tracer.py:203-212); the port, which never
    stalls a ray, counts each ray's own trips. A ray of a well-formed pool
    reaches neither default; one that needs more trips than the unpaged
    cap (a cyclic pool's) stays unresolved here, as in the unpaged trace.
    ``paged`` excludes ``bricks`` and ``warp_table``, as in JAX.

    ``start`` = (node index int32[N], node centre f32[N, 3], depth
    int32[N]), in the rays' order, sets where each ray's first descent
    begins, as JAX's ``_init_state`` takes it (tracer.py:239-290): any
    ancestor whose cell holds the ray's entry point gives the root
    descent's results (``beam_start`` makes such starts). It wins over the
    table's lookup, and with a combined table the ray's first step skips no
    empty cube (its skip side starts at 0, as in JAX); later restarts are
    the table's or the root's as without it. Under ``visits`` the marks are
    those of the descents actually taken.

    ``warp_in_body=False`` reads ``warp_table`` (either kind) for each ray's
    first descent only, as JAX's ``trace_staged`` does by default
    (tracer.py:1745-1777): a ray starts at its entry cell's stored node,
    and its restarts go to the parent or the root, with no step skipped. A
    ``start`` given wins over the table, which is then not read at all.

    ``warp_levels``, if given, must equal the table's levels (JAX indexes
    its table by it; the port reads the levels from the table's length).
    ``unroll`` and ``fuse_sibling`` are JAX's loop-composition knobs, whose
    hits are bit-identical by JAX's own contract; they are validated (JAX
    excludes ``fuse_sibling`` beside ``bricks`` and ``paged``) and change
    nothing here. (JAX's fused sibling step can raise empty-leaf visit
    counts; the port counts as without it.)

    On a CUDA device this launches kernel K1 (its ``start`` forms when a
    start is given, its seed forms for ``warp_in_body=False``); on the CPU
    it is ``trace_plain``.
    """
    operator.index(unroll)
    _check_warp_levels(warp_table, warp_levels)
    dev = dirs.device
    image = dirs.dim() == 3
    kernels.check(dirs, "dirs", _F32, (None, None, 3) if image else (None, 3), dev)
    width = dirs.shape[1] if image else 0
    dirs = dirs.reshape(-1, 3)
    n = dirs.shape[0]
    kernels.check(origins, "origins", _F32, (n, 3), dev, broadcast_rows=True)
    if active_init is not None:
        kernels.check(active_init, "active_init", torch.bool, (n,), dev)
    table_mode, levels, visit_mode = _trace_checks(words, n, dev, warp_table, visits,
                                                   visit_flags, bricks, paged, fuse_sibling)
    if start is not None:
        _check_start(start, n, dev)
    iters = _max_iters(max_steps, max_iters)
    if not kernels.uses_kernel(dev):
        return trace_plain(words, origins, dirs, active_init, max_steps,
                           strict_descent, warp_table, visits, visit_flags,
                           parent_restart, iters, bricks, brick_k, start=start,
                           warp_in_body=warp_in_body)

    res = TraceResult(
        hit=torch.empty(n, dtype=torch.bool, device=dev),
        forced=torch.empty(n, dtype=torch.bool, device=dev),
        index=torch.empty(n, dtype=_I32, device=dev),
        hit_pos=torch.empty((n, 3), dtype=_F32, device=dev),
        normal=torch.empty((n, 3), dtype=_F32, device=dev),
        steps=torch.empty(n, dtype=_I32, device=dev),
        depth=torch.empty(n, dtype=_I32, device=dev),
        word=torch.empty(n, dtype=_I32, device=dev),
    )
    kernels.launch(
        "trace", "ot_trace", dev,
        kernels.ptr(words), words.numel(), kernels.ptr(origins),
        0 if origins.stride(0) == 0 else 3, kernels.ptr(dirs),
        kernels.ptr(active_init), n, width,
        kernels.ptr(warp_table), table_mode, levels, int(strict_descent),
        int(not parent_restart), max_steps, iters, *[kernels.ptr(f) for f in res],
        kernels.ptr(visits), visit_mode, kernels.ptr(bricks), _brick_k(brick_k),
        *(kernels.ptr(t) for t in (start or (None, None, None))), int(warp_in_body),
    )
    return res


def _entry_points(origins: torch.Tensor, dirs: torch.Tensor):
    """JAX ``_init_state``'s prologue (tracer.py:250-261) on [N, 3] rays:
    (entry point f32[N, 3], entered bool[N]); the origin inside the root
    cube, else the slab entry (the origin on a miss)."""
    o = origins.to(_F32)
    d = dirs.to(_F32)
    d = torch.where(d == 0.0, _EPS_DIR, d)
    inside = _in_bounds(o)
    dist = _ray_box_dist(o, d)
    return torch.where(inside[:, None], o, o + d * dist[:, None]), inside | (dist != 0.0)


def _check_beam(words, origin, dirs, block, max_beam_depth):
    kernels.check(words, "words", _I32, (None,), dirs.device)
    _check_pool(words)
    kernels.check(origin, "origin", _F32, (3,), dirs.device)
    kernels.check(dirs, "dirs", _F32, (None, None, 3), dirs.device)
    h, w = dirs.shape[:2]
    if operator.index(block) < 1 or h % block or w % block:
        raise ValueError(f"beam block {block} must divide {h}x{w}")
    if operator.index(max_beam_depth) < 0:
        raise ValueError(f"max_beam_depth must be >= 0, got {max_beam_depth}")
    if 3 * h * w >= 1 << 31:
        raise ValueError(f"{h * w} rays: K11 indexes rays in int32, so n < 2^31 / 3")


def beam_start_plain(words, origin, dirs, block=16, max_beam_depth=12,
                     strict_descent=True):
    """Plain PyTorch version of kernel K11, JAX ``beam_start``
    (tracer.py:2987) expression by expression; its powers of two are
    ``_pow2``'s, exact (JAX's are up to 12 levels on the CPU, ROADMAP §3)."""
    _check_beam(words, origin, dirs, block, max_beam_depth)
    h, w = dirs.shape[:2]
    hb, wb = h // block, w // block
    nb, n_pool = hb * wb, words.shape[0]
    pool = widen_u32(words)
    entry, entered = _entry_points(origin.reshape(1, 3).expand(h * w, 3), dirs.reshape(-1, 3))

    def corners(a):
        a = a.reshape((h, w) + tuple(a.shape[1:]))
        return torch.stack([a[0::block, 0::block], a[block - 1::block, 0::block],
                            a[0::block, block - 1::block],
                            a[block - 1::block, block - 1::block]]).reshape((4, nb) + a.shape[2:])

    def above(p, c):
        return p > c if strict_descent else p >= c

    cpos, all_entered = corners(entry), corners(entered).all(dim=0)
    ref = cpos[0]
    centre = torch.zeros((nb, 3), dtype=_F32, device=dirs.device)
    sdepth = torch.zeros(nb, dtype=torch.int64, device=dirs.device)
    agree = torch.ones(nb, dtype=torch.bool, device=dirs.device)
    for _ in range(max_beam_depth):  # the corners' common spatial path
        bits = above(cpos, centre[None])
        same = (bits == bits[0:1]).all(dim=2).all(dim=0) & agree
        step = (bits[0].to(_F32) * 2.0 - 1.0) * _pow2(-(sdepth + 1))[:, None]
        centre = torch.where(same[:, None], centre + step, centre)
        sdepth = torch.where(same, sdepth + 1, sdepth)
        agree = same
    sdepth = torch.where(all_entered, sdepth, 0)

    node = torch.zeros(nb, dtype=torch.int64, device=dirs.device)
    pos = torch.zeros_like(centre)
    depth = torch.zeros_like(sdepth)
    alive = torch.ones_like(agree)
    marks = []
    for _ in range(max_beam_depth):  # the pool along corner 0's path, above leaves
        pb = above(ref, pos)
        idx = node + pb[:, 0].long() * 4 + pb[:, 1].long() * 2 + pb[:, 2].long()
        payload = pool[idx.clamp(0, n_pool - 1)] >> 4
        ok = alive & (depth < sdepth) & (payload < VOXEL_OFFSET)
        step = (pb.to(_F32) * 2.0 - 1.0) * _pow2(-(depth + 1))[:, None]
        marks.append(torch.where(ok, idx, n_pool))
        node = torch.where(ok, payload, node)
        pos = torch.where(ok[:, None], pos + step, pos)
        depth = torch.where(ok, depth + 1, depth)
        alive = ok
    visit_idx = (torch.stack(marks, dim=1) if marks
                 else torch.zeros((nb, 0), dtype=torch.int64, device=dirs.device))

    def upsample(a):
        a = a.reshape((hb, 1, wb, 1) + tuple(a.shape[1:]))
        return a.expand((hb, block, wb, block) + tuple(a.shape[4:])).reshape(
            (h * w,) + tuple(a.shape[4:]))

    r_index, r_pos, r_depth = upsample(node), upsample(pos), upsample(depth)
    half = _pow2(-r_depth)[:, None]
    if strict_descent:
        in_cell = torch.all((entry > r_pos - half) & (entry <= r_pos + half), dim=1)
    else:
        in_cell = torch.all((entry >= r_pos - half) & (entry < r_pos + half), dim=1)
    ok = in_cell & (r_depth > 0)
    start = (torch.where(ok, r_index, 0).to(_I32), torch.where(ok[:, None], r_pos, 0.0),
             torch.where(ok, r_depth, 0).to(_I32))
    return start, visit_idx.to(_I32)


def beam_start(words, origin, dirs, block=16, max_beam_depth=12, strict_descent=True):
    """The beam pre-pass of JAX ``beam_start`` (tracer.py:2987): for each
    ``block`` x ``block`` tile of the image ``dirs`` (f32[H, W, 3], from
    ``origin`` f32[3]), the deepest node (at most ``max_beam_depth`` levels,
    above leaves) whose cell holds the entry points of the tile's four
    corner rays, and for each ray that node where its own entry point lies
    in the node's cell, else the root.

    Returns (start, beam_visit_idx): ``start`` = (node index int32[H*W],
    centre f32[H*W, 3], depth int32[H*W]) in pixel order, ``trace``'s
    ``start``; ``beam_visit_idx`` int32[tiles, max_beam_depth], the tiles
    in row-major order, the interior slots each tile's descent entered,
    padded with the pool's length. ``block`` must divide H and W. On a CUDA
    device this launches kernel K11; on the CPU it is ``beam_start_plain``.
    """
    dev = dirs.device
    _check_beam(words, origin, dirs, block, max_beam_depth)
    if not kernels.uses_kernel(dev):
        return beam_start_plain(words, origin, dirs, block, max_beam_depth, strict_descent)
    h, w = dirs.shape[:2]
    n, nb = h * w, (h // block) * (w // block)
    tile_state = torch.empty((nb, 5), dtype=_I32, device=dev)
    visit_idx = torch.empty((nb, max_beam_depth), dtype=_I32, device=dev)
    start = (torch.empty(n, dtype=_I32, device=dev), torch.empty((n, 3), dtype=_F32, device=dev),
             torch.empty(n, dtype=_I32, device=dev))
    kernels.launch("beam_start", "ot_beam_start", dev, kernels.ptr(words), words.numel(),
                   kernels.ptr(origin), kernels.ptr(dirs), h, w, block, max_beam_depth,
                   int(strict_descent), kernels.ptr(tile_state), kernels.ptr(visit_idx),
                   *(kernels.ptr(t) for t in start))
    return start, visit_idx


def beam_start_bytes(n: int, tiles: int, max_beam_depth: int, rows: int) -> int:
    """Bytes K11 must move, each once: a direction in (12) and a start out
    (20) a ray, the origin (12), ``max_beam_depth`` entries of
    ``beam_visit_idx`` a tile and the ``rows`` 32-byte pool rows the tiles'
    descents read."""
    return 32 * n + 12 + 4 * tiles * max_beam_depth + 32 * rows


def _brick_k(brick_k) -> int:
    """``brick_k`` as the kernel's int: at most 2^31 - 1 sub-steps a trip (a
    count below 1 takes none, as JAX's ``range``)."""
    return max(min(int(brick_k), (1 << 31) - 1), 0)


def trace_shadow(words, result: TraceResult, sun_dir=DEFAULT_SUN, cull=True,
                 warp_table=None, visits=None, max_steps=MAX_STEPS,
                 strict_descent=True, parent_restart=True, bricks=None, brick_k=4, *,
                 image_width: int, warp_in_body=True) -> torch.Tensor:
    """bool[N]: whether each shadow ray of ``result`` (``shadow_rays``'s,
    from ``hit_pos + normal * 2.5e-6`` toward ``-normalize(sun_dir)``, active
    on hits, and under ``cull`` only on hits facing the sun) hits geometry.
    ``visits`` (int32[pool]) gets the shadow rays' exact counts added.
    ``image_width`` is the width of the image whose pixels ``result`` holds
    in order, which the kernel takes in 8x4 tiles as ``trace`` takes an
    image's dirs, or 0 for a batch in linear order. ``parent_restart``,
    ``bricks``, ``brick_k`` and ``warp_in_body`` are ``trace``'s. On a CUDA
    device this launches kernel K1 in its shadow mode, which builds each
    ray from the result in its prologue and writes only ``hit``; on the CPU
    it is ``shadow_rays`` and ``trace_plain``."""
    dev = words.device
    n = result.hit.shape[0]
    kernels.check(result.hit, "hit", torch.bool, (n,), dev)
    kernels.check(result.hit_pos, "hit_pos", _F32, (n, 3), dev)
    kernels.check(result.normal, "normal", _F32, (n, 3), dev)
    with np.errstate(invalid="ignore", divide="ignore"):
        neg_sun = _neg_sun(sun_dir)
    if neg_sun.shape != (3,) or not np.isfinite(neg_sun).all():
        raise ValueError(f"sun_dir must be three finite numbers, not all 0: {sun_dir}")
    if image_width < 0 or (image_width and n % image_width):
        raise ValueError(f"image_width {image_width} does not divide {n} rays")
    table_mode, levels, _ = _trace_checks(words, n, dev, warp_table, visits, False,
                                          bricks, None)
    if not kernels.uses_kernel(dev):
        o, d, active = shadow_rays(result, sun_dir, cull)
        return trace_plain(words, o, d, active, max_steps, strict_descent, warp_table,
                           visits, parent_restart=parent_restart, bricks=bricks,
                           brick_k=brick_k, warp_in_body=warp_in_body).hit
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    kernels.launch(
        "trace", "ot_trace_shadow", dev,
        kernels.ptr(words), words.numel(), kernels.ptr(result.hit),
        kernels.ptr(result.hit_pos), kernels.ptr(result.normal),
        *(float(c) for c in neg_sun), int(cull), n, image_width, kernels.ptr(warp_table),
        table_mode, levels, int(strict_descent), int(not parent_restart), max_steps,
        _max_iters(max_steps, None), kernels.ptr(hit), kernels.ptr(visits),
        kernels.ptr(bricks), _brick_k(brick_k), int(warp_in_body),
    )
    return hit


def _k2_descent(words: torch.Tensor, levels: int, cells: torch.Tensor | None = None,
                on_level=None):
    """The descent of JAX ``build_warp_table`` (tracer.py:2859) and
    ``occupancy_from_pool`` (skip.py:66) toward the centres of ``cells``
    (flat x-major indices into the 2^levels grid; every cell by default), in
    f32 as JAX computes it, reading the pool as JAX's row gather does
    (``_row_read``). Returns (node, depth, word), int64: where each descent
    stopped and the last word it read (0 at levels 0). ``on_level(it,
    child, depth, read)``, if given, sees each of the ``levels`` trips: the
    child the comparison picked, the depth it was picked at and the index
    read in the padded pool."""
    pool = _pool_rows(words)
    side = 1 << levels
    c = (torch.arange(side ** 3, dtype=torch.int64, device=words.device)
         if cells is None else cells)
    cells3 = torch.stack([c >> (2 * levels), (c >> levels) & (side - 1),
                          c & (side - 1)], dim=1)
    centre = (cells3.to(_F32) + 0.5) * (2.0 / side) - 1.0
    node = torch.zeros_like(c)
    node_pos = torch.zeros_like(centre)
    depth = torch.zeros_like(c)
    word = torch.zeros_like(c)
    for it in range(levels):
        pb = centre > node_pos
        child = pb[:, 0].long() * 4 + pb[:, 1].long() * 2 + pb[:, 2].long()
        read = _row_read(pool, node, child)
        word = pool[read]
        if on_level is not None:
            on_level(it, child, depth, read)
        payload = word >> 4
        step_ok = (payload < VOXEL_OFFSET) & (depth < levels)
        node_pos2 = node_pos + (pb.to(_F32) * 2.0 - 1.0) / _pow2(depth + 1)[:, None]
        node = torch.where(step_ok, payload, node)
        node_pos = torch.where(step_ok[:, None], node_pos2, node_pos)
        depth = torch.where(step_ok, depth + 1, depth)
    return node, depth, word


def warp_occupancy_plain(words: torch.Tensor, levels: int):
    """Plain PyTorch version of kernel K2. Returns (warp table int32[8^L] of
    u32 words ``(node << 5) | depth``, occupancy bool[8^L])."""
    node, depth, word = _k2_descent(words, levels)
    return narrow_u32((node << 5) | depth), (word >> 4) != VOXEL_OFFSET


def k2_bytes(words: torch.Tensor, levels: int) -> int:
    """Bytes K2 must move for the 2^levels grid of ``words``: 5 a cell out
    (the warp word and the occupancy flag), and each 32-byte sector of the
    pool that the descents read, once (a word past the pool's end reads no
    memory; the pool starts on a sector). Counted on the plain descent, on
    ``words``'s device."""
    n_words = words.shape[0]
    seen = torch.zeros((n_words + 7) // 8, dtype=torch.bool, device=words.device)

    def mark(it, child, depth, read):
        seen[read[read < n_words] >> 3] = True

    _k2_descent(words, levels, on_level=mark)
    return 5 * 8 ** levels + 32 * int(seen.sum())


def warp_occupancy(words: torch.Tensor, levels: int):
    """(warp table, occupancy) of the 2^levels grid: per cell, the resume
    word of a root descent toward the cell centre (at most ``levels`` deep,
    stopping above leaves) and whether the cell holds geometry. On a CUDA
    device this launches kernel K2; on the CPU it is
    ``warp_occupancy_plain``."""
    dev = words.device
    kernels.check(words, "words", _I32, (None,))
    _check_pool(words)
    if not 0 <= levels <= 9:
        raise ValueError(f"levels must be in [0, 9], got {levels}")
    if not kernels.uses_kernel(dev):
        return warp_occupancy_plain(words, levels)
    n = 1 << (3 * levels)
    warp = torch.empty(n, dtype=_I32, device=dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    kernels.launch("warp_occupancy", "ot_warp_occupancy", dev,
                   kernels.ptr(words), words.numel(), levels, kernels.ptr(warp),
                   kernels.ptr(occ))
    return warp, occ


def build_warp_table(words: torch.Tensor, levels: int = 6) -> torch.Tensor:
    """Warp table int32[8^levels] (u32 words ``(node << 5) | depth``)."""
    return warp_occupancy(words, levels)[0]


def _neg_sun(sun_dir) -> np.ndarray:
    """-normalize(sun) in f32, normalised as the JAX frame does. A tensor
    (JAX's callers pass the sun as an array) is read to the host first."""
    if isinstance(sun_dir, torch.Tensor):
        sun_dir = sun_dir.detach().cpu()
    sun = np.asarray(sun_dir, dtype=np.float32)
    return -(sun / np.sqrt(np.sum(sun * sun, dtype=np.float32)))


def _lambert(normal: torch.Tensor, neg_sun: np.ndarray) -> torch.Tensor:
    """normal . (-sun), summed in the kernels' order."""
    s = [float(c) for c in neg_sun]
    return (normal[:, 0] * s[0] + normal[:, 1] * s[1]) + normal[:, 2] * s[2]


_POW_CHUNK = 4096  # f32s: whole vectors of every CPU width, under one thread's grain


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** e``, each element's bits independent of the batch it is in.
    PyTorch's CPU pow runs a vector routine over whole pairs of vectors of
    a contiguous run and the C library's for the rest, which rounds
    otherwise; so on the CPU the values go in chunks of ``_POW_CHUNK``,
    the last one padded, and every element takes the vector routine. A
    frame sharded by rows then shades as the whole frame does. On a card
    it is the device's ``powf`` on each element."""
    if x.device.type != "cpu":
        return x ** e
    flat = x.reshape(-1)
    n = flat.numel()
    pad = -n % _POW_CHUNK
    if pad:
        flat = torch.cat([flat, flat.new_ones(pad)])
    out = torch.cat([c ** e for c in flat.split(_POW_CHUNK)])
    return out[:n].reshape(x.shape)


def shade_plain(result: TraceResult, shadow_hit=None, show_steps=False,
                sun_dir=DEFAULT_SUN, gamma=2.2, hits_visits=None) -> torch.Tensor:
    """Plain PyTorch version of K4's shading: f32[N, 3] colours."""
    if show_steps:
        g = div_scalar(result.steps.to(_F32), 64.0)
        return _pow(torch.stack([g, g, g], dim=-1).clamp(0.0, 1.0), gamma)
    if hits_visits is not None:
        slot = result.index.clamp(0, hits_visits.shape[0] - 1).long()  # JAX's clamped gather
        counter = hits_visits[slot].clamp_max(15)
        g = torch.where(result.hit, div_scalar(counter.to(_F32), 15.0), 0.0)
        return _pow(torch.stack([g, g, g], dim=-1).clamp(0.0, 1.0), gamma)
    diffuse = torch.clamp_min(_lambert(result.normal, _neg_sun(sun_dir)), 0.0)
    if shadow_hit is not None:
        diffuse = torch.where(shadow_hit, 0.0, diffuse)
    rgb24 = (widen_u32(result.word) >> 4) - VOXEL_OFFSET
    base = div_scalar(torch.stack(
        [(rgb24 >> 16) & 0xFF, (rgb24 >> 8) & 0xFF, rgb24 & 0xFF], dim=-1
    ).to(_F32), 255.0)
    lit = (0.3 + diffuse)[:, None] * base
    colour = torch.where(result.hit[:, None], lit, 0.2)
    red = torch.tensor([1.0, 0.0, 0.0], dtype=_F32, device=lit.device)
    colour = torch.where(result.forced[:, None], red, colour)
    return _pow(colour.clamp(0.0, 1.0), gamma)


def encode_u8_plain(img: torch.Tensor) -> torch.Tensor:
    """Display encode: ``clip^(1/2.2) * 255`` truncated to u8."""
    return (_pow(img.clamp(0.0, 1.0), 1.0 / 2.2) * 255.0).to(torch.uint8)


def encode_u8(img: torch.Tensor) -> torch.Tensor:
    """The display encode of an f32 image (any shape) to u8, on its device:
    ``clip^(1/2.2) * 255`` truncated. JAX's ``encode_u8`` is an elementwise
    XLA pass, and so is this on every device: PyTorch ops
    (``encode_u8_plain``), on the card its ``powf``. A frame shaded by K4
    with ``u8=True`` gets the same rule from the kernel's threshold search
    (``encode_check`` holds it to the ``powf`` encode)."""
    kernels.check(img, "img", _F32)
    return encode_u8_plain(img)


_ONE_BITS = 0x3F800000  # 1.0f
# K4's per-gamma table (csrc/shade_encode.cu): 256 encode thresholds, the
# gamma of a sky channel (0.2), of 1 and of 0 and their bytes, then one
# bucket a 64th of an octave from 2^-18 to 1.
_SHARED = (0.2, 1.0, 0.0)
_BUCKET0, _BUCKET_SHIFT, _BUCKET_BASE = 262, 17, (127 - 18) << 6
ENCODE_TABLE_SIZE = _BUCKET0 + (_ONE_BITS >> _BUCKET_SHIFT) - _BUCKET_BASE + 1
# Every f32 in [0, 1]: the bit patterns 0 .. 1.0f.
ENCODE_CHECK_VALUES = _ONE_BITS + 1


def encode_table_plain(gamma=2.2, device="cpu") -> torch.Tensor:
    """Plain version of K4's table (``encode_table``), f32[ENCODE_TABLE_SIZE]:
    entry k < 256 the least f32 in [0, 1] whose ``encode_u8_plain`` byte is
    k or more (entry 0 is 0), by bisection over the bit patterns, which for
    non-negative floats are ordered as the values; then the gamma of a sky
    channel, of 1 and of 0, their bytes, and each bucket's encode at its
    lowest value. If the encode is monotone, ``encode_search_plain`` over
    the table is the encode."""
    k = torch.arange(256, device=device)
    lo = torch.zeros(256, dtype=torch.int64, device=device)
    hi = torch.full((256,), _ONE_BITS, dtype=torch.int64, device=device)
    for _ in range(31):
        mid = (lo + hi) // 2
        ge = encode_u8_plain(mid.to(torch.int32).view(_F32)).long() >= k
        hi, lo = torch.where(ge, mid, hi), torch.where(ge, lo, mid + 1)
    t = lo.to(torch.int32).view(_F32).clone()
    t[0] = 0.0
    shared = _pow(torch.tensor(_SHARED, dtype=_F32, device=device).clamp(0.0, 1.0), gamma)
    starts = (torch.arange(ENCODE_TABLE_SIZE - _BUCKET0, device=device) + _BUCKET_BASE
              ) << _BUCKET_SHIFT
    buckets = encode_u8_plain(starts.to(torch.int32).view(_F32))
    return torch.cat([t, shared, encode_u8_plain(shared).to(_F32), buckets.to(_F32)])


def encode_search_plain(img: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The u8 encode as K4 computes it: from the count of thresholds at the
    start of the value's bucket, on through the thresholds at or below
    ``clip(img, 0, 1)``."""
    x = img.clamp(0.0, 1.0).reshape(-1)
    b = (x.view(torch.int32).long() >> _BUCKET_SHIFT) - _BUCKET_BASE
    start = table[_BUCKET0 + b.clamp(0, table.numel() - _BUCKET0 - 1)].long()
    k = torch.where((x > 0) & (b >= 0), start, 0)  # NaN and values under 2^-18: 0
    while True:
        up = (k < 255) & (x >= table[(k + 1).clamp_max(255)])
        if not bool(up.any()):
            return k.to(torch.uint8).reshape(img.shape)
        k = k + up.long()


def k4_bytes(lit: torch.Tensor, out_bytes: int = 3, shadow: bool = True) -> int:
    """Bytes K4 must move for a frame: 2 a ray of masks (hit, forced) and
    ``out_bytes`` a ray out (3 for the u8 frame, 12 for f32), plus the
    32-byte sectors of ``shadow_hit`` (1 byte a ray, when ``shadow``),
    ``word`` (4) and ``normal`` (12) that hold an entry of a pixel in
    ``lit`` (a hit that is not forced: the kernel reads these three only
    there), each counted once; every array starts on a sector."""
    n = lit.numel()
    i = torch.nonzero(lit.reshape(-1)).flatten().to(torch.int64).cpu()
    shadow_sectors = torch.unique(i >> 5).numel() if shadow else 0
    word_sectors = torch.unique(i >> 3).numel()
    normal_sectors = torch.unique(torch.cat([(12 * i) >> 5, (12 * i + 11) >> 5])).numel()
    return n * (2 + out_bytes) + 32 * (shadow_sectors + word_sectors + normal_sectors)


def touched_rows(visits: torch.Tensor) -> int:
    """The 8-word rows that hold a marked slot of ``visits``: the pool rows a
    pass without bricks read, from its visit counts."""
    return int(torch.unique(torch.nonzero(visits).flatten() >> 3).numel())


def k1_bytes(rows: int, n: int, marked: int = 0) -> int:
    """Bytes a primary K1 pass of ``n`` rays must move, each once: the
    ``rows`` 32-byte rows its trips read, the origin and each ray's direction
    in (12 bytes each), 42 bytes of results out a ray, and for a counting
    pass each of the ``marked`` slots it marks read and written (8 bytes)."""
    return rows * 32 + 12 + n * 54 + marked * 8


def k1_shadow_bytes(rows: int, n: int, traced: int, marked: int = 0) -> int:
    """Bytes K1's shadow mode must move, each once: the ``rows`` rows its
    trips read, 2 bytes a ray (the primary hit in, the shadow hit out), the
    12-byte position and normal of each of the ``traced`` rays, and 8 bytes
    for each of the ``marked`` slots of a counting pass."""
    return rows * 32 + n * 2 + traced * 12 + marked * 8


def slot_depths(words: np.ndarray, max_depth: int = 64) -> np.ndarray:
    """int32[pool]: the depth of the node whose child group holds each slot
    (0 for the root group), found from the root through interior words, or
    -1 for a slot no descent reaches. A visit mark of a node at depth d
    lands on a slot of depth d. Groups past the pool's end, and groups seen
    before (a cycle), are not followed."""
    words = np.asarray(words, dtype=np.uint32)
    pool = words.shape[0]
    depth = np.full(pool, -1, np.int32)
    groups = np.zeros(1, np.int64)
    for d in range(max_depth):
        slots = (groups[:, None] * 8 + np.arange(8)).reshape(-1)
        slots = slots[slots < pool]
        slots = slots[depth[slots] < 0]
        if slots.size == 0:
            break
        depth[slots] = d
        payload = (words[slots] >> np.uint32(4)).astype(np.int64)
        child = payload[payload < VOXEL_OFFSET]
        groups = np.unique(child[(child % 8 == 0) & (child < pool)] // 8)
    return depth


def longest_trips(trace_capped, live: torch.Tensor, cap: int) -> int:
    """The loop trips of the longest ray of ``live`` (rays that resolve under
    the trip cap ``cap``): the least T at which ``trace_capped(T)`` (the
    same pass with ``max_iters`` = T) leaves none of them unresolved. A ray
    that resolves reports a depth of 1 or more and one still active after
    T trips reports 0, and a ray resolved under T is resolved under T + 1,
    so a binary search finds T."""
    lo, hi = 0, cap
    while lo < hi:
        mid = (lo + hi) // 2
        if bool(((trace_capped(mid).depth == 0) & live).any()):
            lo = mid + 1
        else:
            hi = mid
    return lo


def shade(result: TraceResult, shadow_hit=None, show_steps=False,
          sun_dir=DEFAULT_SUN, gamma=2.2, u8=False,
          hits_visits=None, block_order=None) -> torch.Tensor:
    """Colours f32[N, 3], or the encoded frame u8[N, 3] when ``u8``.
    ``hits_visits`` (int32[pool]) selects the hit-counter view: hits show
    ``min(visits[index], 15) / 15`` grey, the slot clamped into the pool as
    JAX's gather clamps it (``show_steps`` still wins, as in JAX
    ``shade``). ``block_order`` = (H, W, block, morton) says that the
    result's rays are in ``_pixel_to_block`` order of an H x W image; the
    colours then come out in pixel order (K4 writes each pixel at its
    place). On a CUDA device this launches kernel K4; on the CPU it is
    ``shade_plain`` (and ``encode_u8_plain``)."""
    dev = result.hit.device
    n = result.hit.shape[0]
    kernels.check(result.hit, "hit", torch.bool, (n,), dev)
    kernels.check(result.forced, "forced", torch.bool, (n,), dev)
    kernels.check(result.word, "word", _I32, (n,), dev)
    kernels.check(result.normal, "normal", _F32, (n, 3), dev)
    kernels.check(result.steps, "steps", _I32, (n,), dev)
    if shadow_hit is not None:
        kernels.check(shadow_hit, "shadow_hit", torch.bool, (n,), dev)
    if hits_visits is not None:
        kernels.check(result.index, "index", _I32, (n,), dev)
        kernels.check(hits_visits, "hits_visits", _I32, (None,), dev)
        if hits_visits.shape[0] == 0:
            raise ValueError("hits_visits is empty")
    if block_order is not None:
        bh, bw, block, morton = block_order
        _block_perm(bh, bw, block, morton)
        if bh * bw != n:
            raise ValueError(f"block_order {block_order} does not hold {n} rays")
    if not kernels.uses_kernel(dev):
        img = shade_plain(result, shadow_hit, show_steps, sun_dir, gamma, hits_visits)
        img = encode_u8_plain(img) if u8 else img
        return img if block_order is None else _block_to_pixel(img, *block_order)
    mode = 1 if show_steps else 2 if hits_visits is not None else 0
    out = torch.empty((n, 3), dtype=torch.uint8 if u8 else _F32, device=dev)
    s = _neg_sun(sun_dir)
    kernels.launch(
        "shade_encode", "ot_shade_encode", dev,
        kernels.ptr(result.hit), kernels.ptr(result.forced),
        kernels.ptr(result.word), kernels.ptr(result.normal),
        kernels.ptr(result.steps), kernels.ptr(shadow_hit), n,
        float(s[0]), float(s[1]), float(s[2]), mode, gamma,
        kernels.ptr(result.index), kernels.ptr(hits_visits),
        0 if hits_visits is None else hits_visits.shape[0],
        kernels.ptr(encode_table(dev, gamma)), kernels.ptr(out), int(u8),
        *((0, 0, 0) if block_order is None
          else (block_order[1], block_order[2], int(bool(block_order[3])))),
    )
    return out


_ENCODE_TABLES: dict = {}


def encode_table(device: torch.device, gamma: float) -> torch.Tensor:
    """K4's table for ``gamma`` on ``device`` (``encode_table_plain`` says
    what it holds), computed on the card by the kernel's own ``powf`` at
    first use, then kept; ``encode_check`` verifies that the encode from it
    gives the ``powf`` encode's byte on every f32 in [0, 1]."""
    key = (device, float(gamma))
    t = _ENCODE_TABLES.get(key)
    if t is None:
        t = torch.empty(ENCODE_TABLE_SIZE, dtype=_F32, device=device)
        kernels.launch("shade_encode", "ot_encode_table", device, kernels.ptr(t), gamma,
                       counted=False)
        # Once a gamma: a later call on another stream reads a finished table.
        torch.cuda.current_stream(device).synchronize()
        _ENCODE_TABLES[key] = t
    return t


def encode_check(device: torch.device) -> tuple[int, int, int]:
    """Over every f32 in [0, 1] (one launch): the number of values on which
    K4's threshold search gives another byte than the ``powf`` encode, the
    number of neighbouring values where the ``powf`` encode decreases, and
    the number of values the launch compared, counted by the kernel. The
    search is exact when the first two are 0 and the third is
    ``ENCODE_CHECK_VALUES``."""
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    kernels.launch("shade_encode", "ot_encode_check", device,
                   kernels.ptr(encode_table(device, 2.2)), kernels.ptr(counts), counted=False)
    differ, decrease, compared = counts.tolist()
    return differ, decrease, compared


def shadow_rays(result: TraceResult, sun_dir=DEFAULT_SUN, cull=True):
    """(origins, dirs, active) of the shadow pass: from ``hit_pos + normal *
    2.5e-6`` toward ``-normalize(sun)``, active on hits (forced ones
    included). With ``cull`` only hits whose normal faces the sun: a back
    face shades the same whether or not its shadow ray hits. A frame that
    counts visits traces every hit's ray, because every shadow ray counts
    (JAX ``render_frame``, tracer.py:3452)."""
    neg_sun = _neg_sun(sun_dir)
    n = result.hit.shape[0]
    origins = result.hit_pos + result.normal * _EPS_SHADOW
    dirs = torch.from_numpy(neg_sun).to(origins.device).expand(n, 3).contiguous()
    active = result.hit
    if cull:
        active = active & (_lambert(result.normal, neg_sun) > 0)
    return origins, dirs, active


def agreement(a: dict, b: dict) -> np.ndarray:
    """bool[N]: rays whose hit, index, steps, depth, normal (and word, where
    both have it) are equal in two results given as dicts of NumPy arrays.
    The repository's parity rule allows disagreement only on knife-edge
    rays, below 0.5% of a frame (tests/test_tracer.py:1-11)."""
    agree = np.all(np.asarray(a["normal"]) == np.asarray(b["normal"]), axis=-1)
    for f in ("hit", "index", "steps", "depth", "word"):
        if f in a and f in b:
            agree &= np.asarray(a[f]) == np.asarray(b[f])
    return agree


def to_numpy(result) -> dict:
    """A TraceResult (port or JAX) as a dict of NumPy arrays; ``word`` as
    u32."""
    out = {f: np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
           for f, x in zip(result._fields, result)}
    out["word"] = out["word"].view(np.uint32)
    return out


def overlay_hit_counts(visits: torch.Tensor, result: TraceResult) -> torch.Tensor:
    """Visit flags with exact filled-leaf counts: a filled-leaf visit always
    ends its ray, so the non-forced hits enumerate those visits (JAX
    ``render_frame``, tracer.py:3414-3423). Rays that did not hit, and hits
    past the pool's end (a malformed pool's, which JAX's scatter drops), add
    0 at slot 0, which keeps the scatter free of a host sync."""
    hm = result.hit & ~result.forced & (result.index >= 0) & (result.index < visits.shape[0])
    counts = torch.zeros_like(visits)
    counts.index_add_(0, torch.where(hm, result.index, 0).long(), hm.to(_I32))
    return torch.where(counts > 0, counts, visits)


_MODES = ("tiled", "staged", "beam")


def _beam_morton(beam_iters) -> bool:
    """Whether JAX's beam stage lays its tiles out in Morton order: a
    cascade of more than one stage budget (tracer.py:1797, :1905-1913)."""
    if isinstance(beam_iters, int):
        return False
    its = tuple(beam_iters)
    if not its or not all(isinstance(i, int) for i in its):
        raise ValueError(f"beam_iters must be an int or a sequence of ints, got {beam_iters}")
    return len(its) > 1


def _add_beam_marks(visits: torch.Tensor, visit_idx: torch.Tensor, flags: bool) -> None:
    """JAX's scatter of ``beam_start``'s slots into the visits
    (tracer.py:3541-3549, :3595-3598): +1 each, or under ``flags`` a set
    1; the pool-length padding drops. The slots are interiors, so no
    filled-leaf count is touched."""
    marks = visit_idx.reshape(-1).long()
    real = marks < visits.shape[0]
    slots, ones = torch.where(real, marks, 0), real.to(_I32)
    if flags:
        visits.scatter_reduce_(0, slots, ones, reduce="amax")
    else:
        visits.index_add_(0, slots, ones)


def _check_schedule(mode, h, w, warp_table, warp_levels, with_visits, show_hits,
                    visit_flags, paged, bricks, beams, beam_iters, raw_result,
                    pre_permuted, warp_in_body, shadow_seed, pack_pool, tile_size,
                    max_steps) -> bool:
    """JAX ``render_frame``'s checks of a named ``mode`` (tracer.py:3328-3398)
    and ``trace_staged``'s (:1590-1593, :1790-1796, :1855-1856), in JAX's
    order, and the port's own: a ``warp_levels`` beside the table must be
    its levels, a Morton cascade needs a power-of-two block (JAX asserts
    it), ``tile_size`` is None or a positive int. ``mode=None`` is the
    port's frame, which takes none of the schedule's arguments that change
    a result (``beams``, ``raw_result``, ``pre_permuted``,
    ``warp_in_body=False``). Returns whether the beam stage is a Morton
    cascade."""
    if tile_size is not None and operator.index(tile_size) < 1:
        raise ValueError(f"tile_size must be None or >= 1, got {tile_size}")
    _check_warp_levels(warp_table, warp_levels)
    morton = _beam_morton(beam_iters)
    if mode is None:
        if beams or raw_result or pre_permuted or not warp_in_body:
            raise ValueError("beams, raw_result, pre_permuted and warp_in_body=False need "
                             "a mode ('tiled', 'staged' or 'beam')")
        if paged is not None and (with_visits or show_hits):
            raise ValueError("paged excludes with_visits/show_hits")
        return morton
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES} or None, got {mode!r}")
    staged = mode in ("staged", "beam")
    if warp_table is not None and not staged:
        raise ValueError("warp_table requires mode='staged' or 'beam'")
    if pre_permuted:
        if mode != "beam":
            raise ValueError("pre_permuted requires mode='beam'")
        if morton:
            raise ValueError("pre_permuted excludes morton beam cascades")
    if paged is not None:
        if not staged:
            raise ValueError("paged requires mode='staged' or 'beam'")
        if with_visits or show_hits:
            raise ValueError("paged excludes with_visits/show_hits")
    if shadow_seed and with_visits:
        raise ValueError("shadow_seed excludes with_visits")
    if visit_flags and not show_hits and not staged:
        raise ValueError("visit_flags requires mode='staged' or 'beam'")
    if mode == "beam":
        bb = beams or 8
        if h % bb or w % bb:
            raise ValueError(f"beam block {bb} must divide {h}x{w}")
        if morton:
            _block_perm(h, w, bb, True)
    if staged:
        if max_steps > 1023:
            raise ValueError("trace_staged packs steps/depth into 10 bits")
        if mode == "beam" and max_steps > 127:
            raise ValueError("beam mode packs steps into 7 bits")
        if pack_pool and (bricks is not None or paged is not None):
            raise ValueError("pack9 excludes bricks/paged")
    return morton


def render_frame(words, origin, dirs, sun_dir=DEFAULT_SUN, shadows=True,
                 show_steps=False, misc_bool=False, max_steps=MAX_STEPS,
                 warp_table=None, u8_image=False, with_visits=False,
                 show_hits=False, visit_flags=False, parent_restart=True, bricks=None,
                 brick_k=4, paged=None, paged_old_of_new=None, mode=None,
                 tile_size=128 * 1024, beams=None, beam_iters=16, raw_result=False,
                 pre_permuted=False, warp_levels=None, warp_in_body=True,
                 fit_stages=True, shadow_seed=None, pack_pool=None):
    """Full frame: primary trace, shadow trace, shade (and u8 encode).

    ``origin`` f32[3] and ``dirs`` f32[H, W, 3] on the pool's device;
    ``sun_dir`` three floats on the host (or a tensor of them).
    Returns (image f32[H, W, 3] or u8[H, W, 3], TraceResult in pixel order,
    visits int32[pool] or None). The primary pass traces the image in tiles
    from one origin; the shadow pass (``trace_shadow``) builds
    ``shadow_rays``'s rays from the primary result and yields only their hit
    mask. ``misc_bool`` selects the ``>=`` descent and gamma 1.0.

    ``with_visits`` counts, per pool slot, the reads of every ray of both
    passes, as JAX ``render_frame`` (tracer.py:3377-3560) does: the primary
    pass records 0/1 flags under ``visit_flags`` and then takes the exact
    filled-leaf counts from its hits (``overlay_hit_counts``); the shadow
    pass, not back-face culled while counting, adds exact counts. The
    adaptive thresholds read only the filled-leaf counts and the interior
    zero-set, which both modes give exactly. ``show_hits`` forces exact
    counts and no shadows, and shows ``min(visits, 15) / 15`` on hits.
    ``parent_restart`` goes to both passes (``trace``'s): False gives the
    reference's full re-descent and its visit magnitudes.

    ``bricks`` and ``brick_k`` go to both passes (``trace``'s; ``words``
    the decorated pool). ``paged`` is the geometry of a relayouted pool
    ``words`` (``trace``'s); with ``paged_old_of_new`` (a
    ``PagedPool.old_of_new``, on the pool's device or on the host) the
    result's ``index`` is mapped back to original slots, as JAX's
    (tracer.py:3531-3539). ``paged`` excludes ``with_visits`` and
    ``show_hits``, as in JAX.

    The JAX frame's schedules. ``mode=None`` (the default) is the port's
    frame as above. A named ``mode``, JAX's ``"tiled"``, ``"staged"`` or
    ``"beam"``, raises JAX's ``ValueError``s for its combinations (a table,
    ``visit_flags`` or ``paged`` only in staged or beam mode, and the rest
    of ``_check_schedule``) and computes what JAX computes:

    - ``beams`` = b in the tiled and staged modes (b dividing H and W, else
      ignored, as in JAX) starts each ray's first descent at its b x b
      tile's ``beam_start`` node and, under ``with_visits``, adds the
      tiles' descents to the visits (+1 a slot, a set 1 under
      ``visit_flags``), as JAX does; in beam mode b (default 8) is the
      tile of the block order, which must divide H and W.
    - In beam mode ``pre_permuted=True`` takes ``dirs`` in the block order
      (``camera.generate_rays_device(block_major=b)`` reshaped to [H, W,
      3]), and ``raw_result=True`` returns the TraceResult in the block
      order (Morton within a tile under a ``beam_iters`` cascade), with the
      image in pixel order either way: K1 traces the block order as a flat
      batch, whose 32 consecutive rays of an 8-wide block are an 8x4 tile,
      and K4 writes each pixel at its place.
    - ``warp_in_body=False`` (staged or beam, with a table) reads the table
      for each ray's first descent only, as JAX's ``trace_staged`` does, so
      restarts go to the parent or the root and no step skips: both passes
      go to ``trace``'s and ``trace_shadow``'s ``warp_in_body`` (K1's seed
      forms).

    JAX's tuning knobs ``tile_size``, ``beam_iters`` (but for the Morton
    order of a raw result), ``fit_stages``, ``shadow_seed``, ``pack_pool``
    and ``warp_levels`` (which must equal the table's levels) give outputs
    that JAX holds bit-identical; they are validated as JAX validates them
    and have no effect on the card. A mode's visits are the port's exact
    ones: JAX's staged replays and beam lockstep change only magnitudes
    that its adaptive thresholds do not read (``trace_staged``).
    """
    with timing.span("render.frame"):
        h, w = dirs.shape[:2]
        n = h * w
        morton = _check_schedule(mode, h, w, warp_table, warp_levels, with_visits, show_hits,
                                 visit_flags, paged, bricks, beams, beam_iters, raw_result,
                                 pre_permuted, warp_in_body, shadow_seed, pack_pool, tile_size,
                                 max_steps)
        if show_hits:
            shadows, with_visits, visit_flags = False, True, False
        strict = not misc_bool
        gamma = 2.2 - 1.2 * misc_bool
        visits = None
        if with_visits:
            visits = torch.zeros(words.shape[0], dtype=_I32, device=words.device)
        start = visit_idx = None
        if mode in ("tiled", "staged") and beams and h % beams == 0 and w % beams == 0:
            start, visit_idx = beam_start(words, origin, dirs, block=beams, strict_descent=strict)
        order = None  # the block order of the primary rays
        if mode == "beam" and (raw_result or pre_permuted):
            order = (h, w, beams or 8, morton)
            flat = dirs.reshape(n, 3)
            rays = (flat if pre_permuted else _pixel_to_block(flat, *order)).contiguous()
        else:
            rays = dirs.contiguous()
        origins = origin.reshape(1, 3).contiguous().expand(n, 3)  # one point, stride 0
        kw = dict(max_steps=max_steps, strict_descent=strict, parent_restart=parent_restart,
                  bricks=bricks, brick_k=brick_k, warp_table=warp_table,
                  warp_in_body=warp_in_body)
        with timing.span("render.trace"):
            result = trace(words, origins, rays, visits=visits, visit_flags=visit_flags,
                           paged=paged, start=start, **kw)
            if with_visits and visit_flags:
                visits = overlay_hit_counts(visits, result)
        shadow_hit = None
        if shadows and not show_steps:
            with timing.span("render.shadow"):
                shadow_hit = trace_shadow(words, result, sun_dir, cull=not with_visits,
                                          visits=visits, image_width=0 if order else w, **kw)
        if with_visits and visit_idx is not None:
            _add_beam_marks(visits, visit_idx, visit_flags)
        if paged is not None and paged_old_of_new is not None:
            # Hit slots back to the original pool's (the rest of the result is
            # slot-independent).
            old = torch.as_tensor(paged_old_of_new, device=words.device)
            slot = old[result.index.clamp(0, old.shape[0] - 1).long()].to(_I32)
            result = result._replace(index=torch.where(result.index >= 0, slot, result.index))
        with timing.span("render.shade"):
            img = shade(result, shadow_hit, show_steps=show_steps and not show_hits,
                        sun_dir=sun_dir, gamma=gamma, u8=u8_image,
                        hits_visits=visits if show_hits else None, block_order=order)
        if order is not None and not raw_result:
            result = TraceResult(*(_block_to_pixel(f, *order) for f in result))
        return img.reshape(h, w, 3), result, visits


def _pack_result(result: TraceResult, active: torch.Tensor) -> torch.Tensor:
    """JAX ``trace_staged``'s result record (tracer.py:2135-2174), int32[N,
    8] rows [meta2, index, hit_pos bits, word, 0, 0] with meta2 = steps |
    depth << 10 | active << 20 | hit << 21 | forced << 22 | normal code <<
    23 (each normal component + 1, base 3). ``active``: rays still active
    when the loop ended."""
    nrm = result.normal.to(_I32) + 1
    meta2 = (result.steps | (result.depth << 10) | (active.to(_I32) << 20)
             | (result.hit.to(_I32) << 21) | (result.forced.to(_I32) << 22)
             | ((nrm[:, 0] + 3 * nrm[:, 1] + 9 * nrm[:, 2]) << 23))
    zero = torch.zeros_like(meta2)
    return torch.stack([meta2, result.index, *result.hit_pos.view(_I32).unbind(1),
                        result.word, zero, zero], dim=1)


def _record_fields(result: TraceResult, slim: bool) -> TraceResult:
    """The TraceResult JAX ``trace_staged`` reads back from its record
    (tracer.py:2760-2782), field by field: ``steps`` and ``depth`` in 10
    bits each (a forced ray's ``max_steps + 1`` steps carry into ``depth``'s
    bits at 1023), the normal from its code (components in {-1, 0, 1}, so
    only a -0.0 becomes +0.0); a slim record carries no index (-1),
    position or word (0)."""
    result = result._replace(steps=result.steps & 1023,
                             depth=(result.depth | (result.steps >> 10)) & 1023,
                             normal=result.normal + 0.0)
    if slim:
        result = result._replace(index=torch.full_like(result.index, -1),
                                 hit_pos=torch.zeros_like(result.hit_pos),
                                 word=torch.zeros_like(result.word))
    return result


def trace_staged(words, origins, dirs, active_init=None, max_steps=MAX_STEPS,
                 strict_descent=True, with_visits=False, parent_restart=True,
                 schedule=None, backstop_size=None, unroll=1, tail_unroll=8,
                 start=None, warp_table=None, warp_levels=None, warp_in_body=False,
                 fuse_sibling=None, entry_width=None, beam_shape=None, beam_iters=16,
                 beam_unroll=1, beam_raw=False, beam_pre_permuted=False, beam_aux=False,
                 bricks=None, brick_k=4, paged=None, slim_result=False, rebeam_lanes=64,
                 rebeam_k=0, beam_sparse_skip=None, tail_fine=None, tail_burst=64,
                 fit_stages=True, pack_pool=None, beam_pack=False, visit_flags=False):
    """JAX ``trace_staged`` (tracer.py:1477): its staged-compaction
    wavefront's results, from one ``trace`` (K1 on a CUDA device).

    Returns JAX's tuple: (TraceResult, visits int32[pool] or None), and
    under ``beam_aux`` the result record as a third element (int32[N, 8]
    rows [meta2, index, hit_pos bits, word, 0, 0], in the block order under
    ``beam_shape``). The result holds what JAX reads back from that record
    (``_record_fields``): ``steps`` and ``depth`` in 10 bits each, the
    normal from its code; under ``slim_result`` with ``index`` -1 and
    ``hit_pos`` and ``word`` 0.

    What changes a result, as in JAX: ``start`` (``trace``'s); a
    ``warp_table``, which by default (``warp_in_body=False``) sets only each
    ray's first descent and is in the loop only under ``warp_in_body``;
    ``beam_shape`` = (H, W, block), under which the rays are pixels of an
    H x W image: ``beam_pre_permuted`` takes them in the block order of
    ``_pixel_to_block`` (Morton within a tile under a ``beam_iters``
    cascade), and ``beam_raw`` and the record keep the block order; and
    ``active_init``, ``bricks``, ``brick_k``, ``paged``, ``visit_flags``.

    ``schedule``, ``backstop_size``, ``unroll``, ``tail_unroll``,
    ``fuse_sibling``, ``entry_width``, ``beam_iters``, ``beam_unroll``,
    ``rebeam_lanes``, ``rebeam_k``, ``beam_sparse_skip``, ``tail_fine``,
    ``tail_burst``, ``fit_stages``, ``pack_pool`` and ``beam_pack`` order
    JAX's work, whose hits JAX holds bit-identical to ``trace``; JAX's
    errors for them are raised here too (``max_steps`` over 1023, over 127
    in beam mode, ``slim_result`` beside ``beam_aux`` or ``bricks``, a
    ``beam_shape`` that does not tile the rays or beside ``start`` or
    ``entry_width``, ``pack_pool`` beside ``bricks`` or ``paged``), and
    otherwise they have no effect. The visits are ``trace``'s: JAX replays
    the rays that overflow a stage, which raises only interior and
    empty-leaf magnitudes (tracer.py:1578-1586), so its filled-leaf counts
    and interior zero-set equal these.
    """
    n = dirs.shape[0]
    if max_steps > 1023:
        raise ValueError("trace_staged packs steps/depth into 10 bits")
    if slim_result and (beam_aux or bricks is not None):
        raise ValueError("slim_result excludes beam_aux/bricks")
    if pack_pool and (bricks is not None or paged is not None):
        raise ValueError("pack9 excludes bricks/paged")
    _check_warp_levels(warp_table, warp_levels)
    order = None
    if beam_shape is not None:
        bh, bw, bb = beam_shape
        if bh * bw != n or bh % bb or bw % bb:
            raise ValueError(f"beam_shape {beam_shape} incompatible with {n}")
        if start is not None or entry_width is not None:
            raise ValueError("beam_shape excludes start/entry_width")
        if max_steps > 127:
            raise ValueError("beam mode packs steps into 7 bits")
        order = (bh, bw, bb, _beam_morton(beam_iters))
        _block_perm(*order)
        if not beam_pre_permuted:
            if origins.stride(0) != 0:
                origins = _pixel_to_block(origins, *order).contiguous()
            dirs = _pixel_to_block(dirs, *order).contiguous()
            if active_init is not None:
                active_init = _pixel_to_block(active_init, *order).contiguous()
    visits = (torch.zeros(words.shape[0], dtype=_I32, device=words.device)
              if with_visits else None)
    result = trace(words, origins, dirs, active_init, max_steps, strict_descent, warp_table,
                   visits, visit_flags, parent_restart, bricks=bricks, brick_k=brick_k,
                   paged=paged, start=start, unroll=unroll, fuse_sibling=bool(fuse_sibling),
                   warp_in_body=warp_in_body)
    aux = ()
    if beam_aux:
        live = _entry_points(origins, dirs)[1]
        if active_init is not None:
            live = live & active_init
        aux = (_pack_result(result, live & ~result.hit & (result.depth == 0)),)
    result = _record_fields(result, slim_result)
    if order is not None and not beam_raw:
        result = TraceResult(*(_block_to_pixel(f, *order) for f in result))
    return (result, visits) + aux


