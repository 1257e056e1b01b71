"""Node formats and the two octree variants (the JAX package's ``core``)."""

from .cpu_octree import BIN_DTYPE, CpuOctree
from .octree import Octree
from .voxel import (
    CHUNK_OFFSET,
    COUNTER_MAX,
    VOXEL_OFFSET,
    child_offset,
    interior_word,
    is_leaf_word,
    leaf_word,
    pack_rgb,
    unpack_rgb,
    word_counter,
    word_payload,
)

__all__ = [
    "BIN_DTYPE", "CpuOctree", "Octree", "CHUNK_OFFSET", "COUNTER_MAX",
    "VOXEL_OFFSET", "child_offset", "interior_word", "is_leaf_word",
    "leaf_word", "pack_rgb", "unpack_rgb", "word_counter", "word_payload",
]
