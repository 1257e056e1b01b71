"""Structure stamping: placing block-built props (trees, crystals) in chunks
(the JAX package's ``gen/structures.py``, copied; host NumPy and the native
batch insert, no device work).

Structures are lists of (integer offset, block id) loaded from
``<asset_root>/structures/<name>.vox`` and stamped into a chunk as block
references: a crystal on every chunk-centre grass cell, a tree on a seeded
1-in-100 of the other grass cells past 0.2 of the centre.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .. import native
from ..core.cpu_octree import CpuOctree
from ..core.voxel import CHUNK_OFFSET
from ..io.vox import load_structure
from ..world.world import resolve_asset_root


@functools.lru_cache(maxsize=16)
def load_structure_file(name: str, asset_root: str | None = None):
    """Load ``<asset_root>/structures/<name>.vox`` -> (offsets int32[N,3],
    block ids); ``asset_root`` None is ``OT_ASSET_ROOT``. Cached: world
    generation stamps the same asset once per chunk."""
    path = os.path.join(resolve_asset_root(asset_root), "structures", f"{name}.vox")
    with open(path, "rb") as f:
        return load_structure(f.read())


def stamp_structure(
    chunk: CpuOctree,
    base_pos,
    offsets: np.ndarray,
    block_ids: np.ndarray,
    depth: int,
) -> int:
    """Stamp a structure anchored at ``base_pos`` (chunk-local [-1,1] coords):
    each voxel becomes a block reference at ``depth`` via ``put_in_block``
    (reference: src/procedural.rs:266-279). Out-of-chunk voxels are skipped.
    Returns the number of blocks placed."""
    base_pos = np.asarray(base_pos, dtype=np.float32)
    voxel_size = np.float32(2.0 / (1 << depth))
    placed = 0
    for off, block in zip(offsets, block_ids):
        pos = base_pos + off.astype(np.float32) * voxel_size
        if np.any(pos < -1.0) or np.any(pos >= 1.0):
            continue
        chunk.put_in_block(pos, int(block), depth)
        placed += 1
    return placed


def scatter_trees(
    chunk: CpuOctree,
    grass_cells: np.ndarray,
    depth: int,
    seed: int = 0,
    probability: float = 0.01,
    asset_root: str | None = None,
) -> int:
    """Place tree structures on a random subset of grass-top cells, mirroring
    the reference's 1-in-100 placement rule (src/procedural.rs:280-294).

    ``grass_cells``: integer (x, y, z) cells of grass blocks at ``depth``.
    Returns total blocks stamped."""
    if grass_cells.shape[0] == 0:
        return 0
    rng = np.random.default_rng(seed)
    pick = rng.random(grass_cells.shape[0]) < probability
    scale = np.float32(2.0 / (1 << depth))
    bases = grass_cells[pick].astype(np.float32) * scale - 1.0
    return _stamp_many(chunk, bases, "tree", depth, asset_root)


def _stamp_many(chunk, bases, name, depth, asset_root) -> int:
    """Stamp one named structure at each base position (``scatter_trees``;
    ``place_structures`` batches its two structures into one list)."""
    pos, ptrs, vals = _stamp_list(bases, name, depth, asset_root)
    return _apply_stamps(chunk, pos, ptrs, vals, depth)


def _apply_stamps(chunk, pos, ptrs, vals, depth) -> int:
    """Apply a flattened stamp list: the native batch insert when the
    library is available, else the ``put_in_block`` loop, which leaves the
    same arrays (``tests/test_torch_gen.py``)."""
    if pos.shape[0] == 0:
        return 0
    if native.available() and len(chunk) >= 8:
        new_p, new_v = native.stamp_leaves(
            chunk.pointers, chunk.values, pos, ptrs, vals, depth
        )
        chunk.adopt_arrays(new_p, new_v)
    else:
        for i in range(pos.shape[0]):
            chunk.put_in_block(
                pos[i], int(ptrs[i] - CHUNK_OFFSET), depth
            )
    return pos.shape[0]


def _stamp_list(bases, name, depth, asset_root):
    """The flattened (pos f32[M,3], leaf_ptrs u32[M], leaf_vals u32[M])
    stamp list for one named structure at each base, in the exact order the
    per-voxel loop would insert (out-of-chunk voxels dropped). Zero bases
    never touch the asset file."""
    bases = np.asarray(bases, dtype=np.float32).reshape(-1, 3)
    if bases.shape[0] == 0:
        z = np.zeros(0, dtype=np.uint32)
        return np.zeros((0, 3), np.float32), z, z
    offs, blocks = load_structure_file(name, asset_root)
    voxel_size = np.float32(2.0 / (1 << depth))
    pos = (bases[:, None, :] + offs[None].astype(np.float32) * voxel_size)
    pos = pos.reshape(-1, 3)
    ptrs = np.tile(CHUNK_OFFSET + blocks.astype(np.uint32), bases.shape[0])
    keep = np.all((pos >= -1.0) & (pos < 1.0), axis=1)
    pos, ptrs = pos[keep], ptrs[keep]
    return pos, ptrs, np.zeros(ptrs.shape[0], dtype=np.uint32)


def grass_cells_from_packed(packed: np.ndarray, chunk_depth: int,
                            block_id: int = 3) -> np.ndarray:
    """Extract the (x, y, z) cells holding ``block_id`` from the 2-bit-packed
    C-order grid (``_block_grid_packed`` layout: cell ``16*i + k`` in bits
    ``[2k, 2k+1]`` of word ``i``). Vectorized per bit lane — no full unpack
    (the dense u8 grid is 134 MB at depth 9)."""
    s = 1 << chunk_depth
    packed = packed.view(np.uint32)
    hits = []
    for k in range(16):
        (wi,) = np.nonzero(((packed >> np.uint32(2 * k)) & 3) == block_id)
        if wi.size:
            hits.append(wi.astype(np.int64) * 16 + k)
    if not hits:
        return np.zeros((0, 3), dtype=np.int32)
    flat = np.sort(np.concatenate(hits))
    return np.stack(
        [flat // (s * s), (flat // s) % s, flat % s], axis=1
    ).astype(np.int32)


def place_structures(
    chunk: CpuOctree,
    grass_cells: np.ndarray,
    depth: int,
    seed: int = 0,
    probability: float = 0.01,
    asset_root: str | None = None,
) -> int:
    """The reference's full placement rule (dead code,
    src/procedural.rs:263-295): every chunk-center-column grass cell gets a
    crystal (ascending height, later stamps overwriting); every other grass
    cell with chunk-local ``sqrt(x^2 + z^2) > 0.2`` gets a tree with
    probability 1/100. Deterministic per (seed, cell). Returns total blocks
    stamped."""
    if grass_cells.shape[0] == 0:
        return 0
    s = 1 << depth
    scale = np.float32(2.0 / s)
    base = grass_cells.astype(np.float32) * scale - 1.0
    total = 0

    center = grass_cells[:, 0] == s // 2
    # the reference keys on x==center && z==center; our grid is (x, y, z)
    center = center & (grass_cells[:, 2] == s // 2)
    # The reference stamps a crystal for EVERY center-column grass cell, in
    # ascending height so later (higher) stamps overwrite — last-write-wins
    # (src/procedural.rs:263-295). grass_cells arrive flat-index sorted, which
    # within the fixed (x, z) center column is ascending y, so taking them in
    # order reproduces that rule exactly (matters on overhang terrain with
    # several grass cells in the column).
    crystal_bases = base[center]

    dist = np.sqrt(base[:, 0] ** 2 + base[:, 2] ** 2)
    rng = np.random.default_rng(seed)
    pick = (rng.random(grass_cells.shape[0]) < probability) & (dist > 0.2)
    pick &= ~center
    # ONE combined batch (crystal first, then trees — insertion order
    # preserved): the native path copies the whole chunk SoA in and out per
    # call, so batching halves the full-tree copy traffic.
    parts = [_stamp_list(crystal_bases, "crystal", depth, asset_root),
             _stamp_list(base[pick], "tree", depth, asset_root)]
    pos = np.concatenate([p[0] for p in parts])
    ptrs = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    total += _apply_stamps(chunk, pos, ptrs, vals, depth)
    return total
