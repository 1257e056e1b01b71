"""Deterministic scenes that need no asset file.

``deep_shell`` is the bench's deep10 scene (bench.py:203-244): a spherical
shell of radius 0.95 one leaf thick at ``depth``. ``random_scene`` is a small
random tree for tests. Both build pool words with :func:`build_leaves`, a
vectorised NumPy replica of the JAX package's ``native.build_leaves`` layout,
so the port builds the bench's pool word for word without the native library
or any module of the JAX package. ``shell_world`` is the deep shell as a
streaming world for the Session. ``write_asset_root`` writes a synthetic
block library and structures in the layout the World and the structure
stamps read, for runs without the reference's assets. ``terrain`` is a
generated island chunk that spans the root cube, seen from
``TERRAIN_CAMERA`` low over its surface, a scene whose rays cross many fine
cells; ``chain_pool`` is a pool whose every descent is one long chain of
dependent row reads.
"""

from __future__ import annotations

import os

import numpy as np

from .core.cpu_octree import CpuOctree
from .core.voxel import CHUNK_OFFSET, VOXEL_OFFSET
from .io.vox import build_octree_leaves
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


def _blob(rng, side: int, n_colours: int, fill: float) -> tuple[np.ndarray, np.ndarray]:
    """Cells and colours of a random multi-colour shape in a ``side``^3
    cube: the cells of a ball of radius ``fill * side / 2`` around the
    centre, each with one of ``n_colours`` random non-black colours."""
    g = np.arange(side) + 0.5 - side / 2.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    cells = np.argwhere(x * x + y * y + z * z <= (fill * side / 2.0) ** 2)
    palette = rng.integers(1 << 16, 1 << 24, n_colours).astype(np.uint32)
    return cells, palette[rng.integers(0, n_colours, cells.shape[0])]


def write_asset_root(root: str, seed: int = 0, block_depth: int = 3) -> str:
    """Write a synthetic asset root under ``root`` and return it: the eight
    blocks of ``world.BLOCK_NAMES`` as ``blocks/<name>.vox``, each a
    multi-colour ball of side ``2^block_depth``, and ``structures/tree.vox``
    (a trunk and a crown) and ``structures/crystal.vox`` (a column), whose
    colours are block ids 2-6 once loaded (``io.vox.load_structure``)."""
    from .io.vox_export import save_vox
    from .world.world import BLOCK_NAMES

    rng = np.random.default_rng(seed)
    side = 1 << block_depth
    os.makedirs(os.path.join(root, "blocks"), exist_ok=True)
    os.makedirs(os.path.join(root, "structures"), exist_ok=True)
    for i, name in enumerate(BLOCK_NAMES):
        cells, rgb = _blob(rng, side, 2 + i % 4, 0.7 + 0.04 * i)
        tree = build_octree_leaves(cells, np.full(cells.shape[0], CHUNK_OFFSET), rgb,
                                   block_depth)
        with open(os.path.join(root, "blocks", f"{name}.vox"), "wb") as f:
            f.write(save_vox(tree, block_depth))
    # Structures: 16^3 models; colour k of the sorted palette loads as block k + 2.
    trunk = [(8, y, 8) for y in range(6)]
    crown = [(x, y, z) for x in range(5, 12) for y in range(6, 11) for z in range(5, 12)
             if (x - 8) ** 2 + (y - 8) ** 2 + (z - 8) ** 2 <= 10]
    column = [(8, y, 8) for y in range(12)] + [(7, y, 8) for y in range(3, 9)]
    shapes = {"tree": (trunk + crown, [0x402010] * len(trunk) + [0x20A020] * len(crown)),
              "crystal": (column, [0x80C0F0 + 0x10 * (y % 3) for _, y, _ in column])}
    for name, (cells, rgb) in shapes.items():
        tree = build_octree_leaves(np.array(cells, np.uint32),
                                   np.full(len(cells), CHUNK_OFFSET),
                                   np.array(rgb, np.uint32), 4)
        with open(os.path.join(root, "structures", f"{name}.vox"), "wb") as f:
            f.write(save_vox(tree, 4))
    return root


# A low camera over the island's top surface, looking across it: the rays
# toward the horizon graze the surface (position, look, vertical fov).
TERRAIN_CAMERA = (np.array([0.0, 0.2, -0.7], np.float32),
                  np.array([0.1, -0.25, 1.0], np.float32), 70.0)
# Leaf colours of the generator's block ids (stone, grass).
_TERRAIN_RGB = {1: 0x808080, 3: 0x40A030}


def terrain(depth: int = 9, device="cuda") -> np.ndarray:
    """Pool words of the generated island terrain at ``chunk_depth`` =
    ``depth``: ``Procedural.generate_chunk`` of the chunk whose corner is
    (-1, -1, -1) at base depth 0, so the chunk is the root cube and a cell's
    side is 2^(1 - depth). Its block references become leaves of a colour a
    block (stone grey, grass green). ``device`` runs the grid (K7 on the
    card, its plain version on the CPU)."""
    from .gen.procedural import Procedural

    chunk = Procedural(depth, device=device).generate_chunk((-1.0, -1.0, -1.0), 0)
    ptr, val = chunk.pointers, chunk.values
    rgb = np.zeros(max(_TERRAIN_RGB) + 1, np.uint32)
    for block, colour in _TERRAIN_RGB.items():
        rgb[block] = colour
    block = np.where(ptr > CHUNK_OFFSET, ptr - CHUNK_OFFSET, 0)
    colour = np.where(ptr > CHUNK_OFFSET, rgb[np.minimum(block, rgb.shape[0] - 1)], val)
    return np.where(ptr < CHUNK_OFFSET, ptr << np.uint32(4),
                    (np.uint32(VOXEL_OFFSET) + colour) << np.uint32(4)).astype(np.uint32)


def chain_pool(groups: int, seed: int = 0) -> np.ndarray:
    """Pool words of ``groups`` groups whose every word points at the next
    group of one random cycle through all of them: a descent never ends,
    and each of its trips reads a row it did not read in the last
    ``groups - 1`` trips. One ray traced with ``max_iters`` = T takes T
    dependent row reads and stays unresolved (K1's trip latency)."""
    if groups < 2:
        raise ValueError("a chain needs at least 2 groups")
    order = np.random.default_rng(seed).permutation(groups)
    nxt = np.empty(groups, np.int64)
    nxt[order] = np.roll(order, -1)
    return np.repeat((8 * nxt).astype(np.uint32) << np.uint32(4), 8)


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
    """Pools whose pointers run past their end or cycle, as no well-formed
    tree's do. JAX reads them with a clamped row gather
    (``render/tracer.py`` ``_row_read``), and the port is held to it (and,
    for ``self_cycle``, to the NumPy oracle):

    - ``past_end16``: 16 words. Every root child points at group 16, past
      the end, so every descent reads row 1: seven empty leaves and, last, a
      filled one.
    - ``ragged21``: 21 words, the last row cut after 5. Root children point
      at group 8, at group 16 (whose children 5-7 are past the end and read
      0, a pointer back to the root) and at group 40 (past the end); row 1
      holds leaves and a pointer to node 19, inside row 2 but off its start.
    - ``moved_random``: ``random_scene(5, 300, 1)`` with every 7th interior
      pointer moved 2^15 words past the end, onto the last row (leaves).
    - ``self_cycle``: 8 words, a root group whose child 0 is a filled leaf
      and whose other children point back at the root. A descent ends only
      at child 0; once the cell's centre stops moving in f32 (its half
      side under half an ulp of the centre), a ray whose position is above
      the centre on some axis takes the same child forever, passes 126
      levels, where the powers of two turn subnormal and then 0, and runs
      to the loop's cap.

    Past the end of a pool whose length is no multiple of 8, a row reads 0,
    a pointer to the root.
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
    self_cycle = np.array([_leaf(0xD0A040)] + [_ptr(0)] * 7, dtype=np.uint32)
    return {"past_end16": past_end16, "ragged21": ragged21, "moved_random": moved,
            "self_cycle": self_cycle}
