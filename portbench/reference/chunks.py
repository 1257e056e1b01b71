"""Chunk files read back by the reference: ``<id>.bin``, one node a record
of 8 bytes (u32 pointer, r, g, b, pad), little-endian; the root group at
slots 0-7, child ``x * 4 + y * 2 + z`` of a node at its pointer's slot. A
pointer below 2^31 names an interior's child group, 2^31 a leaf of colour
rgb (black is empty), above 2^31 a block or chunk id ``pointer - 2^31``."""

from __future__ import annotations

import numpy as np

CHUNK_OFFSET = 1 << 31
RECORD = np.dtype([("pointer", "<u4"), ("r", "u1"), ("g", "u1"), ("b", "u1"), ("pad", "u1")])


def read(path: str) -> np.ndarray:
    """The file's records."""
    return np.fromfile(path, dtype=RECORD)
