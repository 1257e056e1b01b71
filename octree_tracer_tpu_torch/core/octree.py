"""Streamed octree: the flat u32 node pool mirrored into device memory (the
JAX package's ``core/octree.py``, copied; tests hold it equal to the
original).

The first 8 slots are the root's children; child groups are 8-aligned and
recycled through a hole stack. Every mutation lands in a patch journal, and
every collapse in a freed-group journal, so the device copy is patched with
compact scatters instead of re-uploaded.

One addition: ``max_depth`` is the deepest node depth the tree has held. The
visit closure (``adaptive.feedback.propagate_visits``) takes its pass count
from it instead of a fixed cap.
"""

from __future__ import annotations

import numpy as np

from .voxel import VOXEL_OFFSET, child_offset, interior_word, leaf_word, word_payload


def node_depth(positions: np.ndarray) -> np.ndarray:
    """Depth of each node from its centre f32[..., 3]: a depth-d centre
    coordinate is an odd multiple of 2^-d, exactly in f32, so the trailing
    zeros of ``x * 2^24`` give 24 - d (depths up to 23)."""
    xi = np.maximum(np.abs(positions[..., 0] * (1 << 24)).astype(np.int64), 1)
    tz = np.zeros_like(xi)
    for shift in (16, 8, 4, 2, 1):
        m = (xi & ((1 << shift) - 1)) == 0
        tz[m] += shift
        xi[m] >>= shift
    return 24 - tz


class Octree:
    """Streamed node pool with subdivide/unsubdivide and hole recycling."""

    def __init__(self, mask_rgb24):
        """``mask_rgb24``: 8 RGB24 colours for the root's children."""
        mask_rgb24 = np.asarray(mask_rgb24, dtype=np.uint32)
        if mask_rgb24.shape != (8,):
            raise ValueError("root mask must have 8 entries")
        self._cap = 64
        self._len = 8
        self._nodes = np.zeros(self._cap, dtype=np.uint32)
        self._positions = np.zeros((self._cap, 3), dtype=np.float32)
        self._nodes[:8] = leaf_word(mask_rgb24)
        self._positions[:8] = child_offset(np.arange(8), 1)
        self.hole_stack: list[int] = []
        self._dirty: list[tuple[int, int]] = []  # (start, stop) spans
        self._freed: list[int] = []  # group bases released since drain_freed
        self.max_depth = 1

    def __len__(self) -> int:
        return self._len

    @property
    def nodes(self) -> np.ndarray:
        """Live view of the node words (length == len(self))."""
        return self._nodes[: self._len]

    @property
    def positions(self) -> np.ndarray:
        """Live view of node-centre positions."""
        return self._positions[: self._len]

    def get_node(self, index: int) -> int:
        """Payload of node ``index``."""
        return int(word_payload(self._nodes[index]))

    def expanded(self, size: int) -> np.ndarray:
        """Zero-padded copy of the pool."""
        out = np.zeros(size, dtype=np.uint32)
        out[: self._len] = self.nodes
        return out

    def _grow(self, need: int) -> None:
        while self._cap < need:
            self._cap *= 2
        if self._nodes.shape[0] < self._cap:
            nodes = np.zeros(self._cap, dtype=np.uint32)
            nodes[: self._len] = self._nodes[: self._len]
            positions = np.zeros((self._cap, 3), dtype=np.float32)
            positions[: self._len] = self._positions[: self._len]
            self._nodes = nodes
            self._positions = positions

    def _mark(self, start: int, stop: int) -> None:
        self._dirty.append((start, stop))

    def note_depth(self, slots: np.ndarray) -> None:
        """Raise ``max_depth`` to the depth of the nodes at ``slots`` (for
        engines that write the buffers directly)."""
        if len(slots):
            self.max_depth = max(self.max_depth,
                                 int(node_depth(self._positions[slots]).max()))

    def subdivide(self, node: int, mask_rgb24, depth: int) -> None:
        """Replace leaf ``node`` with an interior node whose 8 children, at
        ``depth``, take the colours ``mask_rgb24``; recycles a hole if one is
        available."""
        if self.get_node(node) < VOXEL_OFFSET:
            raise ValueError(f"node {node} already subdivided")
        mask_rgb24 = np.asarray(mask_rgb24, dtype=np.uint32)
        pos = self._positions[node]
        if self.hole_stack:
            index = self.hole_stack.pop()
        else:
            index = self._len
            self._grow(index + 8)
            self._len += 8
        self._nodes[node] = interior_word(index)
        self._nodes[index : index + 8] = leaf_word(mask_rgb24)
        self._positions[index : index + 8] = pos + child_offset(np.arange(8), depth)
        self.max_depth = max(self.max_depth, int(depth))
        self._mark(node, node + 1)
        self._mark(index, index + 8)

    def unsubdivide(self, node: int) -> None:
        """Collapse interior ``node``: push its child group on the hole stack
        and mark it with a red placeholder until the caller writes the mip
        colour."""
        tnipt = self.get_node(node)
        if tnipt >= VOXEL_OFFSET:
            return
        self.hole_stack.append(tnipt)
        self._freed.append(tnipt)
        self._nodes[node] = leaf_word(np.uint32(255 << 16))
        self._mark(node, node + 1)

    def set_leaf(self, node: int, rgb24) -> None:
        """Write a leaf colour into slot ``node``."""
        self._nodes[node] = leaf_word(np.uint32(rgb24))
        self._mark(node, node + 1)

    def find_voxel(self, pos, max_depth: int | None = None):
        """Point-location descent from the root (``>=`` comparisons); returns
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
            payload = self.get_node(idx)
            if payload >= VOXEL_OFFSET or depth == (max_depth or 2**31):
                return idx, depth, node_pos
            node_index = payload

    def hole_fraction(self) -> float:
        """Fraction of pool slots sitting in holes."""
        return 8.0 * len(self.hole_stack) / max(1, self._len)

    def drain_freed(self) -> np.ndarray:
        """The 8 slots of every child group freed since the last drain."""
        if not self._freed:
            return np.zeros(0, dtype=np.int64)
        bases = np.asarray(self._freed, dtype=np.int64)
        self._freed = []
        return (bases[:, None] + np.arange(8, dtype=np.int64)[None]).reshape(-1)

    def drain_patches(self):
        """(indices, words) of every slot touched since the last drain; the
        journal is cleared."""
        if not self._dirty:
            return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.uint32)
        spans = self._dirty
        self._dirty = []
        idx = np.unique(
            np.concatenate([np.arange(a, b, dtype=np.int32) for a, b in spans]))
        return idx, self._nodes[idx]
