"""Ground-truth chunk octree, host-resident (the JAX package's
``core/cpu_octree.py``, copied so the port imports no module of that package;
tests hold it equal to the original).

A growable SoA of ``(pointer, rgb24)`` pairs. ``ptr < CHUNK_OFFSET``: index of
the node's 8-child group; ``== CHUNK_OFFSET``: leaf voxel of colour ``value``
(black = empty); ``> CHUNK_OFFSET``: reference to chunk/block id
``ptr - CHUNK_OFFSET``. ``value`` holds the node's mip colour in every case.
"""

from __future__ import annotations

import numpy as np

from .voxel import CHUNK_OFFSET, VOXEL_OFFSET, child_offset, pack_rgb

_DEFAULT_TOP_MIP = pack_rgb(50, 255, 50)
_RED = pack_rgb(255, 0, 0)

# 8 bytes per node, little-endian: u32 pointer, then r, g, b, one zero pad.
BIN_DTYPE = np.dtype(
    [("pointer", "<u4"), ("r", "u1"), ("g", "u1"), ("b", "u1"), ("pad", "u1")]
)


class CpuOctree:
    """Full-resolution ground-truth octree for one chunk."""

    def __init__(self, mask: int = 0, top_mip: int | None = None):
        self._cap = 64
        self._len = 0
        self._ptr = np.zeros(self._cap, dtype=np.uint32)
        self._val = np.zeros(self._cap, dtype=np.uint32)
        self.top_mip = np.uint32(_DEFAULT_TOP_MIP if top_mip is None else top_mip)
        self.add_voxels(mask)

    @classmethod
    def from_arrays(cls, pointers, values, top_mip: int | None = None,
                    copy: bool = True) -> "CpuOctree":
        tree = cls.__new__(cls)
        pointers = np.ascontiguousarray(pointers, dtype=np.uint32)
        values = np.ascontiguousarray(values, dtype=np.uint32)
        if pointers.shape != values.shape or pointers.ndim != 1:
            raise ValueError("pointers/values must be equal-length 1-D arrays")
        tree._len = pointers.shape[0]
        tree.top_mip = np.uint32(_DEFAULT_TOP_MIP if top_mip is None else top_mip)
        if not copy and tree._len >= 64:
            # Adopt the buffers; the caller hands over ownership.
            tree._cap = tree._len
            tree._ptr = pointers
            tree._val = values
            return tree
        tree._cap = max(64, tree._len)
        tree._ptr = np.zeros(tree._cap, dtype=np.uint32)
        tree._val = np.zeros(tree._cap, dtype=np.uint32)
        tree._ptr[: tree._len] = pointers
        tree._val[: tree._len] = values
        return tree

    def _grow(self, need: int) -> None:
        if need <= self._cap:
            return
        while self._cap < need:
            self._cap *= 2
        ptr = np.zeros(self._cap, dtype=np.uint32)
        val = np.zeros(self._cap, dtype=np.uint32)
        ptr[: self._len] = self._ptr[: self._len]
        val[: self._len] = self._val[: self._len]
        self._ptr = ptr
        self._val = val

    def add_voxels(self, mask: int) -> None:
        """Append one 8-child group. Bits set in ``mask`` become block
        references cycling through block ids 1..8 by slot position."""
        base = self._len
        self._grow(base + 8)
        self._len = base + 8
        for i in range(8):
            if (mask >> i) & 1:
                self._ptr[base + i] = CHUNK_OFFSET + np.uint32((base + i) % 8 + 1)
                self._val[base + i] = _RED
            else:
                self._ptr[base + i] = CHUNK_OFFSET
                self._val[base + i] = 0

    def __len__(self) -> int:
        return self._len

    @property
    def pointers(self) -> np.ndarray:
        return self._ptr[: self._len]

    @property
    def values(self) -> np.ndarray:
        return self._val[: self._len]

    def free_nodes(self) -> None:
        """Drop node storage, keeping ``top_mip``."""
        self._len = 0
        self._cap = 64
        self._ptr = np.zeros(self._cap, dtype=np.uint32)
        self._val = np.zeros(self._cap, dtype=np.uint32)

    def find_voxel(self, pos, max_depth: int | None = None):
        """Descend to the leaf (or chunk ref) containing ``pos``; returns
        (index, depth, centre)."""
        pos = np.asarray(pos, dtype=np.float32)
        node_index = 0
        node_pos = np.zeros(3, dtype=np.float32)
        depth = 0
        while True:
            depth += 1
            p = (pos >= node_pos).astype(np.int64)
            child_index = int(p[0] * 4 + p[1] * 2 + p[2])
            node_pos = node_pos + child_offset(child_index, depth)
            idx = node_index + child_index
            ptr = int(self._ptr[idx])
            if ptr >= int(CHUNK_OFFSET) or depth == (max_depth or 2**31):
                return idx, depth, node_pos
            node_index = ptr

    def get_node_mask(self, node: int) -> np.ndarray:
        """The 8 children's colours starting at slot ``node``."""
        return self._val[node : node + 8].copy()

    def put_in_voxel(self, pos, rgb24, depth: int) -> None:
        """Insert a voxel colour at ``pos``/``depth``, splitting empty leaves
        on the way down."""
        while True:
            node, node_depth, _ = self.find_voxel(pos)
            if node_depth == depth:
                self._ptr[node] = CHUNK_OFFSET
                self._val[node] = np.uint32(rgb24)
                return
            self._ptr[node] = np.uint32(self._len)
            self.add_voxels(0)

    def put_in_block(self, pos, block_id: int, depth: int) -> None:
        """Insert a chunk/block reference at ``pos``/``depth``."""
        while True:
            node, node_depth, _ = self.find_voxel(pos)
            if node_depth == depth:
                self._ptr[node] = CHUNK_OFFSET + np.uint32(block_id)
                self._val[node] = 0
                return
            self._ptr[node] = np.uint32(self._len)
            self.add_voxels(0)

    def adopt_arrays(self, pointers: np.ndarray, values: np.ndarray) -> None:
        """Replace this tree's storage in place (top_mip is kept)."""
        pointers = np.ascontiguousarray(pointers, dtype=np.uint32)
        values = np.ascontiguousarray(values, dtype=np.uint32)
        if pointers.shape != values.shape or pointers.ndim != 1:
            raise ValueError("pointers/values must be equal-length 1-D arrays")
        if pointers.shape[0] < 8:
            raise ValueError("adopted arrays must hold at least 8 nodes")
        self._ptr = pointers
        self._val = values
        self._len = pointers.shape[0]
        self._cap = self._len

    def to_words(self) -> np.ndarray:
        """The whole tree as streamed node words: interior nodes keep their
        child pointers, every ``ptr >= CHUNK_OFFSET`` node becomes a leaf of
        its (mip) colour."""
        ptr = self.pointers
        val = self.values
        return np.where(
            ptr < CHUNK_OFFSET,
            ptr << np.uint32(4),
            (np.uint32(VOXEL_OFFSET) + val) << np.uint32(4),
        ).astype(np.uint32)

    def raw(self) -> np.ndarray:
        """A copy of the pointer array alone."""
        return self.pointers.copy()

    def _bin_rec(self) -> np.ndarray:
        rec = np.zeros(self._len, dtype=BIN_DTYPE)
        rec["pointer"] = self.pointers
        rec["r"] = (self.values >> 16) & 0xFF
        rec["g"] = (self.values >> 8) & 0xFF
        rec["b"] = self.values & 0xFF
        return rec

    def to_bin(self) -> bytes:
        """Serialize to the 8-byte-per-node layout (``BIN_DTYPE``)."""
        return self._bin_rec().tobytes()

    def to_file(self, path: str) -> None:
        self._bin_rec().tofile(path)

    @classmethod
    def from_bin(cls, data: bytes) -> "CpuOctree":
        rec = np.frombuffer(data, dtype=BIN_DTYPE)
        values = (
            rec["r"].astype(np.uint32) << 16
            | rec["g"].astype(np.uint32) << 8
            | rec["b"].astype(np.uint32)
        )
        return cls.from_arrays(rec["pointer"].copy(), values, top_mip=0)
