"""``.rsvo`` loader (ephtracy sparse-voxel-octree export format; the JAX
package's ``io/rsvo.py``, copied).

Format per the reference implementation (reference: src/cpu_octree.rs:128-175):
byte 16 holds ``top_level``; little-endian u32 per-level node counts start at
byte 20; child-mask bytes follow in strict breadth-first order. Import depth is
truncated to ``octree_depth`` levels; truncated subtrees remain block
references (ids 1..8 by slot position) that the world resolves into the block
library.

The reference expands masks with a sequential grow-while-scanning loop; here
each level expands in one vectorized pass (the mask stream is BFS-ordered, so
per-level slices line up exactly with the sequential consumption order).
"""

from __future__ import annotations

import numpy as np

from ..core.cpu_octree import CpuOctree
from ..core.voxel import CHUNK_OFFSET, pack_rgb

_RED = pack_rgb(255, 0, 0)


class RsvoError(ValueError):
    pass


def load_rsvo(data: bytes, octree_depth: int) -> CpuOctree:
    buf = np.frombuffer(data, dtype=np.uint8)
    top_level = int(buf[16])
    node_count_start = 20
    data_start = node_count_start + 4 * (top_level + 1)
    node_counts = np.frombuffer(
        data, dtype="<u4", count=top_level + 1, offset=node_count_start
    ).astype(np.int64)

    if octree_depth > top_level:
        raise RsvoError(
            f"Octree depth ({octree_depth}) is greater than top level ({top_level})"
        )

    node_end = int(node_counts[:octree_depth].sum())
    masks = buf[data_start:]

    # Root group from the first mask byte (reference: src/cpu_octree.rs:157).
    ptr_parts = []
    val_parts = []

    def make_group_nodes(group_masks: np.ndarray, base_index: int):
        """Vectorized add_voxels for a batch of groups: bit i set -> block ref
        (slot_index % 8 + 1), else empty leaf."""
        n = group_masks.shape[0]
        bits = (group_masks[:, None] >> np.arange(8, dtype=np.uint8)) & 1  # (n, 8)
        slots = base_index + np.arange(n * 8, dtype=np.int64).reshape(n, 8)
        ptr = np.where(
            bits.astype(bool),
            CHUNK_OFFSET + (slots % 8 + 1).astype(np.uint32),
            CHUNK_OFFSET,
        ).astype(np.uint32)
        val = np.where(bits.astype(bool), np.uint32(_RED), np.uint32(0))
        return ptr.reshape(-1), val.reshape(-1)

    root_ptr, root_val = make_group_nodes(masks[:1], 0)
    ptr_parts.append(root_ptr)
    val_parts.append(root_val)
    total_nodes = 8

    # Frontier: node slots that are block refs awaiting a mask byte, in index
    # (= BFS) order. Every frontier node consumes one mask byte; it expands
    # only while its byte index is below node_end (depth truncation,
    # reference: src/cpu_octree.rs:160-172).
    frontier = np.nonzero(root_ptr > CHUNK_OFFSET)[0].astype(np.int64)
    data_index = 1

    # Patches to apply to already-emitted pointers: (slot, new_pointer).
    patch_slots = []
    patch_ptrs = []

    while frontier.size and data_index < node_end:
        k = frontier.size
        byte_idx = data_index + np.arange(k, dtype=np.int64)
        expand = byte_idx < node_end
        avail = byte_idx < masks.shape[0]
        expand &= avail
        data_index += k

        exp_slots = frontier[expand]
        exp_masks = masks[byte_idx[expand]]
        n_exp = exp_slots.size
        if n_exp == 0:
            break

        # Expanding nodes become interior, pointing at consecutive new groups.
        new_ptrs = (total_nodes + 8 * np.arange(n_exp, dtype=np.int64)).astype(
            np.uint32
        )
        patch_slots.append(exp_slots)
        patch_ptrs.append(new_ptrs)

        ptr, val = make_group_nodes(exp_masks, total_nodes)
        ptr_parts.append(ptr)
        val_parts.append(val)
        frontier = (
            np.nonzero(ptr > CHUNK_OFFSET)[0].astype(np.int64) + total_nodes
        )
        total_nodes += n_exp * 8

    pointers = np.concatenate(ptr_parts)
    values = np.concatenate(val_parts)
    if patch_slots:
        pointers[np.concatenate(patch_slots)] = np.concatenate(patch_ptrs)
    return CpuOctree.from_arrays(pointers, values)
