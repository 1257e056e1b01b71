"""``.rsvo`` exporter — write a CpuOctree as an ephtracy-style SVO file
(the JAX package's ``io/rsvo_export.py``, copied).

The reference only *reads* .rsvo (src/cpu_octree.rs:128-175); exporting closes
the loop so deep scenes (e.g. generated worlds) can round-trip through the
same format the missing benchmark assets (statuette/dragon/sibenik) use:
header with ``top_level`` at byte 16, little-endian u32 per-level node counts
from byte 20, then child-mask bytes in breadth-first order.

Colours are not representable in .rsvo (the format carries only occupancy);
filled leaves and block references set their parent's mask bit, exactly the
information ``load_rsvo`` consumes. Only uniform-leaf-depth trees (``.vox``
imports, generated chunks) are exportable: a solid leaf above the bottom level
would desynchronize the BFS byte stream.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.cpu_octree import CpuOctree
from ..core.voxel import CHUNK_OFFSET


def save_rsvo(tree: CpuOctree, max_depth: int = 24) -> bytes:
    """Serialize occupancy to .rsvo bytes; raises ValueError for trees with
    occupied leaves above the deepest level."""
    ptr = tree.pointers
    val = tree.values
    occupied = (ptr != CHUNK_OFFSET) | (val != 0)

    level_masks: list[np.ndarray] = []
    leaf_counts: list[int] = []
    frontier = np.zeros(1, dtype=np.int64)  # group bases at current level
    for _ in range(max_depth):
        children = (frontier[:, None] + np.arange(8, dtype=np.int64)).reshape(-1)
        occ = occupied[children].reshape(-1, 8)
        masks = (occ << np.arange(8, dtype=np.uint16)).sum(axis=1).astype(
            np.uint8
        )
        level_masks.append(masks)
        interior = ptr[children] < CHUNK_OFFSET
        leaf_counts.append(int((occupied[children] & ~interior).sum()))
        frontier = ptr[children[interior]].astype(np.int64)
        if frontier.size == 0:
            break
    if frontier.size:
        raise ValueError(f"tree deeper than max_depth={max_depth}")
    if any(c for c in leaf_counts[:-1]):
        raise ValueError(
            ".rsvo export requires uniform leaf depth (solid leaf above the "
            "bottom level)"
        )

    top_level = len(level_masks)
    counts = [m.shape[0] for m in level_masks] + [0]
    out = bytearray(b"RSVO" + b"\x00" * 12)  # only offset 16+ is parsed
    out += struct.pack("<B3x", top_level)
    for c in counts:
        out += struct.pack("<I", c)
    for m in level_masks:
        out += m.tobytes()
    return bytes(out)
