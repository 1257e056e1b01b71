"""MagicaVoxel ``.vox`` parser and vectorized octree builder (the JAX
package's ``io/vox.py``, copied).

Self-written parser for the subset the reference consumes through the
``dot_vox`` crate (reference: src/cpu_octree.rs:177-210): first model's SIZE +
XYZI chunks and the RGBA palette, indexed directly with the voxel's colour
byte, exactly like ``dot_vox 4.1`` does.

The tree build replaces the reference's per-voxel root-to-leaf insertion loop
(reference: src/cpu_octree.rs:100-111) with a level-synchronous construction:
voxels are morton-sorted once, then each level's node groups fall out of a
``np.unique`` over morton prefixes. Same tree semantics, O(D) vectorized passes
instead of O(V * D) pointer chasing.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.cpu_octree import CpuOctree
from ..core.voxel import CHUNK_OFFSET


class VoxError(ValueError):
    pass


def parse_vox(data: bytes):
    """Parse a .vox byte string -> (size_xyz, voxels uint8[N,4], palette u32[256]).

    ``voxels`` rows are (x, y, z, colour_index); palette entries are packed
    0xAABBGGRR like dot_vox 4.1 stores them (file byte order r, g, b, a).
    """
    if data[:4] != b"VOX ":
        raise VoxError("not a VOX file")
    pos = 8  # skip magic + version

    size = None
    voxels = None
    palette = None

    def read_chunk(pos):
        cid = data[pos : pos + 4]
        content_len, children_len = struct.unpack_from("<ii", data, pos + 4)
        return cid, pos + 12, content_len, children_len

    cid, content, clen, childlen = read_chunk(pos)
    if cid != b"MAIN":
        raise VoxError("missing MAIN chunk")
    pos = content + clen
    end = content + clen + childlen

    while pos < end:
        cid, content, clen, childlen = read_chunk(pos)
        if cid == b"SIZE" and size is None:
            size = struct.unpack_from("<iii", data, content)
        elif cid == b"XYZI" and voxels is None:
            (n,) = struct.unpack_from("<i", data, content)
            voxels = np.frombuffer(
                data, dtype=np.uint8, count=4 * n, offset=content + 4
            ).reshape(n, 4)
        elif cid == b"RGBA":
            palette = np.frombuffer(
                data, dtype="<u4", count=256, offset=content
            ).copy()
        pos = content + clen + childlen

    if size is None or voxels is None:
        raise VoxError("VOX file has no model")
    if palette is None:
        # Grayscale ramp fallback; every shipped asset carries an RGBA chunk.
        ramp = np.arange(256, dtype=np.uint32) & 0xFF
        palette = (0xFF000000 | (ramp << 16) | (ramp << 8) | ramp).astype(np.uint32)
    return size, voxels, palette


def voxels_to_cells(size: int, voxels: np.ndarray, palette: np.ndarray):
    """Apply the reference's coordinate remap and palette lookup
    (reference: src/cpu_octree.rs:192-207): vox (x, y, z) -> octree cell
    (size-1-x, z, y); colour = palette[i] low bytes (r, g, b)."""
    x = np.uint32(size - 1) - voxels[:, 0].astype(np.uint32)
    y = voxels[:, 2].astype(np.uint32)
    z = voxels[:, 1].astype(np.uint32)
    entry = palette[voxels[:, 3].astype(np.int64)]
    r = entry & 0xFF
    g = (entry >> 8) & 0xFF
    b = (entry >> 16) & 0xFF
    rgb24 = (r << 16) | (g << 8) | b
    return np.stack([x, y, z], axis=1), rgb24.astype(np.uint32)


def _morton_encode(cells: np.ndarray, depth: int) -> np.ndarray:
    """Interleave (x, y, z) cell coords into a morton path key: at each level
    the 3-bit digit is (x_bit<<2)|(y_bit<<1)|z_bit, matching the descent's
    child indexing (reference: src/octree.rs:124-129)."""
    m = np.zeros(cells.shape[0], dtype=np.uint64)
    x = cells[:, 0].astype(np.uint64)
    y = cells[:, 1].astype(np.uint64)
    z = cells[:, 2].astype(np.uint64)
    for level in range(depth):
        shift = np.uint64(depth - 1 - level)
        digit = (
            (((x >> shift) & np.uint64(1)) << np.uint64(2))
            | (((y >> shift) & np.uint64(1)) << np.uint64(1))
            | ((z >> shift) & np.uint64(1))
        )
        m = (m << np.uint64(3)) | digit
    return m


def build_octree(cells: np.ndarray, rgb24: np.ndarray, depth: int) -> CpuOctree:
    """Level-synchronous octree build of colour-leaf cells (``put_in_voxel``
    semantics, reference: src/cpu_octree.rs:100-111)."""
    return build_octree_leaves(
        cells,
        np.full(cells.shape[0], CHUNK_OFFSET, dtype=np.uint32),
        np.asarray(rgb24, dtype=np.uint32),
        depth,
    )


def build_octree_leaves(
    cells: np.ndarray,
    leaf_ptrs: np.ndarray,
    leaf_vals: np.ndarray,
    depth: int,
) -> CpuOctree:
    """Level-synchronous octree build from integer cells at ``depth`` with
    arbitrary leaf (pointer, value) payloads — colour voxels
    (``CHUNK_OFFSET``, rgb) or block references (``CHUNK_OFFSET + id``, 0),
    covering both ``put_in_voxel`` and ``put_in_block`` semantics
    (reference: src/cpu_octree.rs:87-111).

    Produces the same tree semantics as repeated insertion (groups of 8
    siblings along every inserted path, empties as (CHUNK_OFFSET, black),
    duplicates last-wins) with deterministic breadth-first, morton-sorted node
    layout."""
    if depth < 1:
        raise VoxError("octree depth must be >= 1")
    morton = _morton_encode(cells, depth)
    # Last insertion wins on duplicates, like the reference's overwrite.
    order = np.argsort(morton, kind="stable")
    morton = morton[order]
    leaf_ptrs = np.asarray(leaf_ptrs, dtype=np.uint32)[order]
    colors = np.asarray(leaf_vals, dtype=np.uint32)[order]
    keep = np.ones(morton.shape[0], dtype=bool)
    keep[:-1] = morton[:-1] != morton[1:]  # keep the last of each run
    morton = morton[keep]
    leaf_ptrs = leaf_ptrs[keep]
    colors = colors[keep]

    # Unique prefixes per level; prefix of length 3L identifies a depth-L node.
    # Groups at level L+1 are keyed by depth-L prefixes that contain voxels.
    prefixes = []  # prefixes[L-1]: sorted unique depth-L prefixes, L = 1..depth
    for level in range(1, depth + 1):
        shift = np.uint64(3 * (depth - level))
        prefixes.append(np.unique(morton >> shift))

    # Group counts: root group (level 1) always exists; level L+1 has one group
    # per unique depth-L prefix.
    group_counts = [1] + [len(p) for p in prefixes[:-1]]
    starts = np.concatenate([[0], np.cumsum(np.asarray(group_counts) * 8)])
    total = int(starts[-1])

    ptr = np.full(total, CHUNK_OFFSET, dtype=np.uint32)
    val = np.zeros(total, dtype=np.uint32)

    for level in range(1, depth + 1):
        p = prefixes[level - 1]
        # Node slot of each depth-`level` occupied node: its parent group's
        # base plus the low 3 bits of its prefix.
        child = (p & np.uint64(7)).astype(np.int64)
        if level == 1:
            group_base = np.zeros(len(p), dtype=np.int64)
        else:
            parents = prefixes[level - 2]
            rank = np.searchsorted(parents, p >> np.uint64(3))
            group_base = starts[level - 1] + 8 * rank
        slots = group_base + child
        if level < depth:
            # Interior: point at this prefix's child group at the next level.
            rank_here = np.arange(len(p), dtype=np.int64)
            ptr[slots] = (starts[level] + 8 * rank_here).astype(np.uint32)
        else:
            ptr[slots] = leaf_ptrs
            val[slots] = colors

    return CpuOctree.from_arrays(ptr, val)


def load_vox(data: bytes) -> CpuOctree:
    """Parse + build, enforcing the reference's cubic power-of-two requirement
    (reference: src/cpu_octree.rs:177-191)."""
    size, voxels, palette = parse_vox(data)
    if not (size[0] == size[1] == size[2]):
        raise VoxError("Voxel model is not a cube!")
    side = int(size[0])
    depth = side.bit_length() - 1
    if (1 << depth) != side:
        raise VoxError("Voxel model size is not a power of 2!")
    cells, rgb24 = voxels_to_cells(side, voxels, palette)
    return build_octree(cells, rgb24, depth)


def load_structure(data: bytes):
    """Raw (pos, block-id) list for structure stamping
    (reference: src/cpu_octree.rs:213-230)."""
    size, voxels, _ = parse_vox(data)
    pos = np.stack(
        [
            np.int32(size[0]) // 2 - voxels[:, 0].astype(np.int32),
            voxels[:, 2].astype(np.int32),
            voxels[:, 1].astype(np.int32) - np.int32(size[1]) // 2,
        ],
        axis=1,
    )
    return pos, voxels[:, 3].astype(np.uint32) + 1
