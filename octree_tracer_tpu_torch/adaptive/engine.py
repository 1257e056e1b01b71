"""Host adaptive LOD engine: subdivide hot leaves, collapse cold nodes (the
JAX package's ``adaptive/engine.py``, copied; tests hold it equal to the
original and to the native engine).

The device side hands it compacted candidate lists
(``adaptive.feedback.select_candidates_packed``); its mutations land in the
octree's patch journal, which the session drains into device patches.
"""

from __future__ import annotations

import numpy as np

from ..core.voxel import CHUNK_OFFSET, VOXEL_OFFSET
from ..utils import timing


def process_subdivision(candidates, octree, world) -> int:
    """Split each hot-leaf candidate with its ground-truth children's (mip)
    colours from the world; a chunk reference splits from the chunk's root,
    or triggers an async load. Returns the number of splits applied."""
    with timing.span("engine.subdivide"):
        applied = 0
        for node_index in candidates:
            node_index = int(node_index)
            if node_index < 0:
                break  # -1 padding
            if octree.get_node(node_index) < VOXEL_OFFSET:
                continue  # already split
            pos = octree.positions[node_index]
            _, voxel_depth, _ = octree.find_voxel(pos)
            try:
                chunk_id, cpu_index, _, _ = world.find_voxel(pos, max_depth=voxel_depth)
            except (KeyError, IndexError):
                continue  # a chunk on the path is not resident: retry later
            chunk = world.chunks[chunk_id]
            ptr = int(chunk.pointers[cpu_index])
            if ptr < int(CHUNK_OFFSET):
                octree.subdivide(node_index, chunk.get_node_mask(ptr), voxel_depth + 1)
                applied += 1
            elif ptr > int(CHUNK_OFFSET):
                ref_id = ptr - int(CHUNK_OFFSET)
                if ref_id in world.chunks:
                    mask = world.chunks[ref_id].get_node_mask(0)
                    octree.subdivide(node_index, mask, voxel_depth + 1)
                    applied += 1
                else:
                    world.load_chunk(ref_id)  # async; retried next frame
            # ptr == CHUNK_OFFSET: a plain leaf in the world, nothing to split.
        return applied


def process_unsubdivision(candidates, octree, world) -> int:
    """Collapse cold interior candidates: reclaim the child group, stamp the
    world's mip colour (empty where the chunk is not resident), and evict
    generated chunks whose reference collapsed, after the whole batch.
    Returns collapses applied."""
    with timing.span("engine.collapse"):
        applied = 0
        evict_ids: list[int] = []
        for node_index in candidates:
            node_index = int(node_index)
            if node_index < 0:
                break
            if octree.get_node(node_index) >= VOXEL_OFFSET:
                continue  # already a leaf
            octree.unsubdivide(node_index)
            pos = octree.positions[node_index]
            _, voxel_depth, _ = octree.find_voxel(pos)
            value = 0
            try:
                chunk_id, cpu_index, _, _ = world.find_voxel(pos, max_depth=voxel_depth)
            except (KeyError, IndexError):
                pass
            else:
                chunk = world.chunks[chunk_id]
                ptr = int(chunk.pointers[cpu_index])
                value = int(chunk.values[cpu_index])
                if ptr > int(CHUNK_OFFSET):
                    ref_id = ptr - int(CHUNK_OFFSET)
                    if ref_id >= int(CHUNK_OFFSET) // 2:
                        evict_ids.append(ref_id)  # generated terrain chunk
            octree.set_leaf(node_index, np.uint32(value))
            applied += 1
        for ref_id in evict_ids:
            world.evict_chunk(ref_id)
        return applied
