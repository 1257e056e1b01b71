"""Subtree paging of big node pools (the JAX package's
``render/paging.py``).

``build_pages`` relayouts a pool into a small **top** table (every group
whose nodes sit at depth <= K, the root group first) and one contiguous,
padded **page** per occupied depth-K subtree. A node's descendants stay
inside its page, so a ray changes page only through a restart at the root.
JAX's tracer schedules one page's window per loop trip on the TPU, where a
gather from a small window runs at the small-pool rate; rays elsewhere
stall, so its results are the plain traversal's. The relayout keeps the
traversal's semantics exactly: only group placement and the interior
pointers change, and ``old_of_new`` maps each relayouted slot back to its
original slot (-1 for padding) for hit indices.

The port traces a relayouted pool with K1 as it is
(``tracer.trace(..., paged=...)`` checks the geometry) and maps hits back
in ``tracer.render_frame(..., paged_old_of_new=...)``. ``build_pages`` is
host NumPy, the JAX package's own, array for array, so a JAX caller's
pages are the port's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.voxel import VOXEL_OFFSET


class PagedPool(NamedTuple):
    """Relayouted pool + page geometry (Python ints but the arrays);
    ``(top_rows, page_rows, n_pages)`` is ``trace``'s ``paged``."""

    words: np.ndarray        # u32[total] relayouted pool (top ++ pages)
    old_of_new: np.ndarray   # i32[total] original slot of each new slot
    top_rows: int            # top table size in 8-word rows
    page_rows: int           # rows per page (padded)
    n_pages: int             # number of pages
    levels: int              # K


def build_pages(
    words: np.ndarray,
    levels: int | None = None,
    max_page_bytes: int = 4 << 20,
) -> PagedPool:
    """Relayout ``words`` into top + depth-``levels`` subtree pages.

    ``levels=None`` picks the smallest K in 1..3 whose largest subtree fits
    ``max_page_bytes`` (falls back to K=3 with bigger pages if none does).
    """
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if words.shape[0] % 8:
        words = np.pad(words, (0, (-words.shape[0]) % 8))
    n_groups = words.shape[0] // 8
    payload = words >> np.uint32(4)
    interior = (payload < np.uint32(VOXEL_OFFSET)) & (words != 0)
    child_group = (payload // 8).astype(np.int64)  # valid where interior

    # BFS from the root group: depth (of the group's nodes) and owning
    # depth-K octant path prefix, per group. Unreachable groups (holes,
    # garbage) stay unassigned and are dropped from the relayout.
    depth = np.full(n_groups, -1, dtype=np.int32)
    path = np.zeros(n_groups, dtype=np.int64)  # base-8 packed path digits
    depth[0] = 1
    frontier = np.array([0], dtype=np.int64)
    while frontier.size:
        base = frontier * 8
        rows = np.repeat(base, 8) + np.tile(np.arange(8), frontier.size)
        mask = interior[rows]
        kids = child_group[rows[mask]]
        # path digit = child index c of the node that points at the group
        digits = np.tile(np.arange(8, dtype=np.int64), frontier.size)[mask]
        parents = np.repeat(frontier, 8)[mask]
        fresh = depth[kids] < 0
        kids, digits, parents = kids[fresh], digits[fresh], parents[fresh]
        # First writer wins (a well-formed pool has unique parents).
        _, first = np.unique(kids, return_index=True)
        kids, digits, parents = kids[first], digits[first], parents[first]
        depth[kids] = depth[parents] + 1
        path[kids] = path[parents] * 8 + digits
        frontier = kids

    reachable = depth > 0
    max_depth = int(depth.max(initial=1))

    def page_key(K):
        """Page id (path truncated to K digits) per group, -1 for top."""
        d = depth.astype(np.int64)
        in_top = (d <= K) | ~reachable
        # A group at depth d > K keeps its first K path digits: the path has
        # d-1 digits (root group has 0), truncate to K.
        digs = np.maximum(d - 1 - K, 0)
        return np.where(in_top, -1, path >> (3 * digs)), in_top

    if levels is None:
        levels = 3
        for K in (1, 2, 3):
            key, in_top = page_key(K)
            live = key[reachable & ~in_top]
            if live.size == 0:
                levels = K
                break
            biggest = np.bincount(live).max() * 32
            if biggest <= max_page_bytes:
                levels = K
                break
    levels = min(levels, max(max_depth - 1, 1))
    key, in_top = page_key(levels)

    top_groups = np.nonzero(reachable & in_top)[0]
    # Root group first, then BFS order (depth, then original index) — any
    # deterministic order works; pointers are rewritten below.
    top_order = top_groups[np.lexsort((top_groups, depth[top_groups]))]

    page_groups = np.nonzero(reachable & ~in_top)[0]
    pk = key[page_groups]
    if page_groups.size:
        page_ids, rows_per_page = np.unique(pk, return_counts=True)
    else:
        page_ids = np.array([], dtype=np.int64)
        rows_per_page = np.zeros(1, dtype=np.int64)
    n_pages = max(1, page_ids.size)
    page_rows = max(1, int(rows_per_page.max(initial=1)))

    top_rows = max(1, top_order.size)
    total_rows = top_rows + page_rows * n_pages
    new_words = np.zeros(total_rows * 8, dtype=np.uint32)
    old_of_new = np.full(total_rows * 8, -1, dtype=np.int64)
    new_base_of_group = np.full(n_groups, -1, dtype=np.int64)

    new_base_of_group[top_order] = np.arange(top_order.size) * 8
    if page_groups.size:
        # One sort places every page: groups ordered by (page, depth, id) —
        # the same deterministic layout as the former per-page loop, without
        # its O(n_pages * n_groups) scans (big pools: tens of seconds).
        pidx = np.searchsorted(page_ids, pk)
        order = np.lexsort((page_groups, depth[page_groups], pidx))
        gs = page_groups[order]
        ps = pidx[order]
        starts = np.searchsorted(ps, np.arange(n_pages))
        offs = np.arange(gs.size, dtype=np.int64) - starts[ps]
        new_base_of_group[gs] = ((top_rows + ps * page_rows) + offs) * 8

    placed = np.nonzero(new_base_of_group >= 0)[0]
    src = (placed * 8)[:, None] + np.arange(8)[None, :]
    dst = new_base_of_group[placed][:, None] + np.arange(8)[None, :]
    w = words[src.reshape(-1)]
    pl = w >> np.uint32(4)
    is_int = (pl < np.uint32(VOXEL_OFFSET)) & (w != 0)
    kid = (pl // 8).astype(np.int64)
    new_ptr = np.where(
        new_base_of_group[np.clip(kid, 0, n_groups - 1)] >= 0,
        new_base_of_group[np.clip(kid, 0, n_groups - 1)],
        0,
    ).astype(np.uint32)
    w = np.where(
        is_int, (new_ptr << np.uint32(4)) | (w & np.uint32(15)), w
    )
    new_words[dst.reshape(-1)] = w
    old_of_new[dst.reshape(-1)] = src.reshape(-1)

    return PagedPool(
        words=new_words,
        old_of_new=old_of_new.astype(np.int32),
        top_rows=int(top_rows),
        page_rows=int(page_rows),
        n_pages=int(n_pages),
        levels=int(levels),
    )
