"""The deep shell scene, built by the benchmark: the cells of a sphere of
radius 0.95 one leaf thick at ``depth`` and their colours (the JAX bench's
deep10 scene, ``bench.py:203-244``), their octree as pool words in the
layout of the upstream ``build_leaves`` (the root group at 0, then one
8-word group a missing ancestor, top down, in leaf order)."""

from __future__ import annotations

import numpy as np

VOXEL_OFFSET = 1 << 27
_EMPTY_LEAF = np.uint32(VOXEL_OFFSET << 4)


def _key(cells: np.ndarray, bits: int) -> np.ndarray:
    return (cells[:, 0] << (2 * bits)) | (cells[:, 1] << bits) | cells[:, 2]


def shell_cells(depth: int, radius2: float = 0.9025) -> tuple[np.ndarray, np.ndarray]:
    """Sorted unique cells int64[n, 3] and colours u32[n] of the shell."""
    side = 1 << depth
    g = np.arange(side, dtype=np.float32)
    cx = (g + 0.5) / side * 2.0 - 1.0
    xs, ys = np.meshgrid(cx, cx, indexing="ij")
    rng2 = np.float32(radius2) - xs * xs - ys * ys
    zs = np.sqrt(np.maximum(rng2, 0.0))
    keep = rng2 > 0
    cells = []
    for sign in (1.0, -1.0):
        zc = np.clip(((sign * zs + 1.0) * (side / 2.0)).astype(np.int64), 0, side - 1)
        cells.append(np.stack(
            [np.broadcast_to(np.arange(side), (side, side))[keep],
             np.broadcast_to(np.arange(side)[:, None], (side, side))[keep],
             zc[keep]], axis=1))
    cells = np.unique(np.concatenate(cells, axis=0), axis=0)
    rgb = ((cells[:, 0].astype(np.uint32) % 200 + 30) << 16
           | (cells[:, 1].astype(np.uint32) % 200 + 30) << 8
           | (cells[:, 2].astype(np.uint32) % 200 + 30))
    return cells, rgb


def build_leaves(cells: np.ndarray, rgb: np.ndarray, depth: int) -> np.ndarray:
    """Pool words u32 of the octree with colour ``rgb[i]`` at depth-``depth``
    cell ``cells[i]``: groups ordered by (first leaf below the node, depth)."""
    keys, first = {}, {}
    for d in range(1, depth + 1):
        k = _key(cells >> (depth - d), d)
        if d < depth:
            keys[d], first[d] = np.unique(k, return_index=True)
        else:
            rev, last = np.unique(k[::-1], return_index=True)
            keys[d], leaf_rgb = rev, rgb[::-1][last]
    levels = np.concatenate([np.full(keys[d].size, d) for d in range(1, depth)])
    firsts = np.concatenate([first[d] for d in range(1, depth)])
    group = np.empty(firsts.size, dtype=np.int64)
    group[np.lexsort((levels, firsts))] = np.arange(1, firsts.size + 1)
    group_of, start = {}, 0
    for d in range(1, depth):
        group_of[d] = group[start:start + keys[d].size]
        start += keys[d].size
    words = np.full(8 * (firsts.size + 1), _EMPTY_LEAF, dtype=np.uint32)
    for d in range(1, depth + 1):
        k = keys[d]
        child = ((k >> (2 * d)) & 1) << 2 | ((k >> d) & 1) << 1 | (k & 1)
        if d == 1:
            parent = np.zeros(k.size, dtype=np.int64)
        else:
            pk = _key(np.stack([k >> (2 * d), (k >> d) & ((1 << d) - 1),
                                k & ((1 << d) - 1)], axis=1) >> 1, d - 1)
            parent = group_of[d - 1][np.searchsorted(keys[d - 1], pk)]
        slot = 8 * parent + child
        if d < depth:
            words[slot] = (8 * group_of[d]).astype(np.uint32) << np.uint32(4)
        else:
            words[slot] = (np.uint32(VOXEL_OFFSET) + leaf_rgb) << np.uint32(4)
    return words


def shell_words(depth: int) -> np.ndarray:
    """Pool words of the shell at ``depth``."""
    cells, rgb = shell_cells(depth)
    return build_leaves(cells, rgb, depth)
