"""Node word formats (the JAX package's ``core/voxel.py``).

A pool word is ``(payload << 4) | counter``. ``payload < VOXEL_OFFSET`` is the
index of the node's 8-child group; otherwise the node is a leaf and
``payload - VOXEL_OFFSET`` its RGB888 colour (0 = empty).

A ground-truth chunk node is ``(pointer, value)``: ``pointer < CHUNK_OFFSET``
indexes the 8-child group, ``== CHUNK_OFFSET`` is a leaf of colour ``value``,
``> CHUNK_OFFSET`` references chunk ``pointer - CHUNK_OFFSET`` and ``value``
holds the node's mip colour.

``VOXEL_OFFSET`` is a Python int, because the traversal compares PyTorch
tensors with it; the NumPy helpers below use it as a u32.
"""

from __future__ import annotations

import numpy as np

VOXEL_OFFSET = 1 << 27
CHUNK_OFFSET = np.uint32(1 << 31)
COUNTER_BITS = 4
COUNTER_MASK = np.uint32(0xF)
COUNTER_MAX = 15

_VOXEL_OFFSET_U32 = np.uint32(VOXEL_OFFSET)


def pack_rgb(r, g, b):
    """RGB888 -> 24-bit colour."""
    return (np.uint32(r) << np.uint32(16)) | (np.uint32(g) << np.uint32(8)) | np.uint32(b)


def unpack_rgb(value):
    """24-bit colour -> (r, g, b) u32 triple."""
    value = np.asarray(value, dtype=np.uint32)
    return ((value >> np.uint32(16)) & np.uint32(0xFF),
            (value >> np.uint32(8)) & np.uint32(0xFF),
            value & np.uint32(0xFF))


def leaf_word(rgb24):
    """Streamed leaf word for a 24-bit colour, counter 0."""
    return (_VOXEL_OFFSET_U32 + np.asarray(rgb24, dtype=np.uint32)) << np.uint32(COUNTER_BITS)


def interior_word(child_index):
    """Streamed interior word pointing at a child group, counter 0."""
    return np.asarray(child_index, dtype=np.uint32) << np.uint32(COUNTER_BITS)


def word_payload(word):
    """The word without its counter bits."""
    return np.asarray(word, dtype=np.uint32) >> np.uint32(COUNTER_BITS)


def word_counter(word):
    """The word's 4-bit hit counter."""
    return np.asarray(word, dtype=np.uint32) & COUNTER_MASK


def is_leaf_word(word):
    """True where the word is a leaf (payload at or above VOXEL_OFFSET)."""
    return word_payload(word) >= _VOXEL_OFFSET_U32


def child_offset(child_index, depth):
    """Centre offset of child ``child_index`` (0..7; bit2 = x, bit1 = y,
    bit0 = z) at ``depth`` from its parent's centre, float32 (..., 3)."""
    ci = np.asarray(child_index)
    xyz = np.stack([((ci >> 2) & 1).astype(np.float32),
                    ((ci >> 1) & 1).astype(np.float32),
                    (ci & 1).astype(np.float32)], axis=-1)
    scale = np.exp2(np.asarray(depth, dtype=np.float32))[..., None]
    return (xyz * 2.0 - 1.0) / scale
