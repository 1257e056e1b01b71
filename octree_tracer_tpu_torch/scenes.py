"""Deterministic scenes that need no asset file.

``deep_shell`` is the bench's deep10 scene (bench.py:203-244): a spherical
shell of radius 0.95 one leaf thick at ``depth``. ``random_scene`` is a small
random tree for tests. Both build pool words with :func:`build_leaves`, a
vectorised NumPy replica of the JAX package's ``native.build_leaves`` layout,
so the port builds the bench's pool word for word without the native library
or any module of the JAX package. ``shell_world`` is the deep shell as a
streaming world for the Session. ``build_octree_leaves`` is the JAX package's
level-synchronous builder (``io/vox.py:93-184``), copied: the breadth-first
morton layout that the native dense builder also writes, which procedural
chunks take without the native library.
"""

from __future__ import annotations

import numpy as np

from .core.cpu_octree import CpuOctree
from .core.voxel import CHUNK_OFFSET, VOXEL_OFFSET
from .world.world import World

_EMPTY_LEAF = np.uint32(VOXEL_OFFSET << 4)


def _key(cells: np.ndarray, bits: int) -> np.ndarray:
    return (cells[:, 0] << (2 * bits)) | (cells[:, 1] << bits) | cells[:, 2]


def build_leaves(cells: np.ndarray, rgb: np.ndarray, depth: int) -> np.ndarray:
    """Pool words (u32) of the octree with colour ``rgb[i]`` at the
    depth-``depth`` cell ``cells[i]`` (integer x, y, z).

    The layout is ``native.build_leaves``'s: leaves are inserted in order, and
    an insertion appends one 8-word child group for each missing ancestor, top
    down, after the root group at 0. So the groups are ordered by (first leaf
    below the node, node depth). A repeated cell keeps its last colour."""
    cells = np.asarray(cells, dtype=np.int64).reshape(-1, 3)
    rgb = np.asarray(rgb, dtype=np.uint32).reshape(-1)
    if cells.shape[0] != rgb.shape[0]:
        raise ValueError("cells and rgb must have the same length")
    if depth < 1 or cells.size and (cells.min() < 0 or cells.max() >= 1 << depth):
        raise ValueError(f"cells must lie in the 2^{depth} grid")

    # Per level d: the occupied nodes (sorted keys) and the first leaf below each.
    keys, first = {}, {}
    for d in range(1, depth + 1):
        k = _key(cells >> (depth - d), d)
        if d < depth:
            keys[d], first[d] = np.unique(k, return_index=True)
        else:
            rev, last = np.unique(k[::-1], return_index=True)
            keys[d], leaf_rgb = rev, rgb[::-1][last]
    levels = np.concatenate([np.full(keys[d].size, d) for d in range(1, depth)]
                            ) if depth > 1 else np.zeros(0, np.int64)
    firsts = (np.concatenate([first[d] for d in range(1, depth)])
              if depth > 1 else np.zeros(0, np.int64))
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


def _morton_encode(cells: np.ndarray, depth: int) -> np.ndarray:
    """Interleave (x, y, z) cell coordinates into a morton path key whose
    3-bit digit per level is (x_bit << 2) | (y_bit << 1) | z_bit, the
    descent's child index."""
    m = np.zeros(cells.shape[0], dtype=np.uint64)
    x = cells[:, 0].astype(np.uint64)
    y = cells[:, 1].astype(np.uint64)
    z = cells[:, 2].astype(np.uint64)
    for level in range(depth):
        shift = np.uint64(depth - 1 - level)
        digit = ((((x >> shift) & np.uint64(1)) << np.uint64(2))
                 | (((y >> shift) & np.uint64(1)) << np.uint64(1))
                 | ((z >> shift) & np.uint64(1)))
        m = (m << np.uint64(3)) | digit
    return m


def build_octree_leaves(cells: np.ndarray, leaf_ptrs: np.ndarray,
                        leaf_vals: np.ndarray, depth: int) -> CpuOctree:
    """Level-synchronous octree build from integer ``cells`` at ``depth``
    with arbitrary leaf (pointer, value) payloads: colour voxels
    (``CHUNK_OFFSET``, rgb) or block references (``CHUNK_OFFSET + id``, 0).
    The tree of repeated insertion (groups of 8 siblings along every path,
    empties as (``CHUNK_OFFSET``, 0), a repeated cell keeps its last
    payload) in breadth-first, morton-sorted layout."""
    if depth < 1:
        raise ValueError("octree depth must be >= 1")
    morton = _morton_encode(cells, depth)
    order = np.argsort(morton, kind="stable")
    morton = morton[order]
    leaf_ptrs = np.asarray(leaf_ptrs, dtype=np.uint32)[order]
    colors = np.asarray(leaf_vals, dtype=np.uint32)[order]
    keep = np.ones(morton.shape[0], dtype=bool)
    keep[:-1] = morton[:-1] != morton[1:]  # keep the last of each run
    morton, leaf_ptrs, colors = morton[keep], leaf_ptrs[keep], colors[keep]

    # prefixes[L-1]: sorted unique depth-L prefixes; the root group always
    # exists and level L+1 has one group per occupied depth-L node.
    prefixes = [np.unique(morton >> np.uint64(3 * (depth - level)))
                for level in range(1, depth + 1)]
    group_counts = [1] + [len(p) for p in prefixes[:-1]]
    starts = np.concatenate([[0], np.cumsum(np.asarray(group_counts) * 8)])
    total = int(starts[-1])
    ptr = np.full(total, CHUNK_OFFSET, dtype=np.uint32)
    val = np.zeros(total, dtype=np.uint32)
    for level in range(1, depth + 1):
        p = prefixes[level - 1]
        child = (p & np.uint64(7)).astype(np.int64)
        if level == 1:
            group_base = np.zeros(len(p), dtype=np.int64)
        else:
            rank = np.searchsorted(prefixes[level - 2], p >> np.uint64(3))
            group_base = starts[level - 1] + 8 * rank
        slots = group_base + child
        if level < depth:
            rank_here = np.arange(len(p), dtype=np.int64)
            ptr[slots] = (starts[level] + 8 * rank_here).astype(np.uint32)
        else:
            ptr[slots] = leaf_ptrs
            val[slots] = colors
    return CpuOctree.from_arrays(ptr, val)


def shell_cells(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Cells (sorted, unique) and colours of the r = 0.95 shell at ``depth``,
    computed as bench.py:213-238 computes them."""
    side = 1 << depth
    g = np.arange(side, dtype=np.float32)
    cx = (g + 0.5) / side * 2.0 - 1.0
    xs, ys = np.meshgrid(cx, cx, indexing="ij")
    rng2 = 0.9025 - xs * xs - ys * ys
    zs = np.sqrt(np.maximum(rng2, 0.0))
    keep = rng2 > 0
    cells = []
    for sign in (1.0, -1.0):
        zc = np.clip(
            ((sign * zs + 1.0) * (side / 2.0)).astype(np.int64), 0, side - 1
        )
        cells.append(np.stack(
            [np.broadcast_to(np.arange(side), (side, side))[keep],
             np.broadcast_to(np.arange(side)[:, None], (side, side))[keep],
             zc[keep]], axis=1))
    cells = np.unique(np.concatenate(cells, axis=0), axis=0)
    rgb = (
        (cells[:, 0].astype(np.uint32) % 200 + 30) << 16
        | (cells[:, 1].astype(np.uint32) % 200 + 30) << 8
        | (cells[:, 2].astype(np.uint32) % 200 + 30)
    )
    return cells, rgb


def deep_shell(depth: int = 10) -> np.ndarray:
    """Pool words of the bench's deep shell scene at ``depth``."""
    cells, rgb = shell_cells(depth)
    return build_leaves(cells, rgb, depth)


def chunk_from_words(words: np.ndarray) -> CpuOctree:
    """The ground-truth chunk whose ``to_words()`` is ``words``: an interior
    payload becomes the child pointer, a leaf becomes ``CHUNK_OFFSET`` with
    its colour (0 for an empty leaf). Interior values stay 0 until the
    world's mip tree is generated."""
    payload = np.asarray(words, dtype=np.uint32) >> np.uint32(4)
    leaf = payload >= np.uint32(VOXEL_OFFSET)
    return CpuOctree.from_arrays(
        np.where(leaf, CHUNK_OFFSET, payload).astype(np.uint32),
        np.where(leaf, payload - np.uint32(VOXEL_OFFSET), 0).astype(np.uint32),
        copy=False)


def shell_chunk(depth: int = 10) -> CpuOctree:
    """The deep shell (``deep_shell(depth)``) as a ground-truth chunk."""
    return chunk_from_words(deep_shell(depth))


def shell_world(depth: int = 10) -> World:
    """A World (no block library) whose root chunk is ``shell_chunk(depth)``,
    with its mip tree generated: the Session's streaming source."""
    world = World(load_blocks=False)
    world.chunks[0] = shell_chunk(depth)
    world.generate_mip_tree(0)
    return world


def random_scene(depth: int, n_voxels: int, seed: int) -> np.ndarray:
    """Pool words of ``n_voxels`` random cells (repeats allowed) with random
    non-empty colours at ``depth``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 1 << depth, (n_voxels, 3))
    rgb = rng.integers(1, 1 << 24, n_voxels).astype(np.uint32)
    return build_leaves(cells, rgb, depth)


def _leaf(rgb: int) -> np.uint32:
    return np.uint32((VOXEL_OFFSET + rgb) << 4)


def _ptr(node: int) -> np.uint32:
    return np.uint32(node << 4)


def malformed_pools() -> dict[str, np.ndarray]:
    """Pools whose pointers run past their end, as no well-formed tree's do.
    JAX reads them with a clamped row gather (``render/tracer.py``
    ``_row_read``), and the port is held to it:

    - ``past_end16``: 16 words. Every root child points at group 16, past
      the end, so every descent reads row 1: seven empty leaves and, last, a
      filled one.
    - ``ragged21``: 21 words, the last row cut after 5. Root children point
      at group 8, at group 16 (whose children 5-7 are past the end and read
      0, a pointer back to the root) and at group 40 (past the end); row 1
      holds leaves and a pointer to node 19, inside row 2 but off its start.
    - ``moved_random``: ``random_scene(5, 300, 1)`` with every 7th interior
      pointer moved 2^15 words past the end, onto the last row (leaves).

    Past the end of a pool whose length is no multiple of 8, a row reads 0,
    a pointer to the root; descents that keep returning there grow deeper
    than 126 levels, past where K1's powers of two are exact, so the pools
    that rays trace here return there only a few times.
    """
    empty = np.uint32(VOXEL_OFFSET << 4)
    past_end16 = np.array([_ptr(16)] * 8 + [empty] * 7 + [_leaf(0x30C050)],
                          dtype=np.uint32)
    ragged21 = np.array(
        [_ptr(8)] * 4 + [_ptr(16), _ptr(16), _ptr(40), empty]
        + [_leaf(0xC03020), empty, _ptr(19), _leaf(0x2080E0), empty, _leaf(0x10F010),
           _ptr(16), empty]
        + [_leaf(0xE0E0E0), empty, _leaf(0x4040C0), empty, empty], dtype=np.uint32)
    moved = random_scene(5, 300, 1)
    interior = np.nonzero((moved >> np.uint32(4)) < VOXEL_OFFSET)[0]
    moved[interior[::7]] = _ptr(moved.shape[0] + (1 << 15))
    return {"past_end16": past_end16, "ragged21": ragged21, "moved_random": moved}
