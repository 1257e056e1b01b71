"""Streamed octree: the flat u32 node pool mirrored into device memory (the
JAX package's ``core/octree.py``, copied; tests hold it equal to the
original).

The first 8 slots are the root's children; child groups are 8-aligned and
recycled through a hole stack. Every mutation lands in a patch journal, and
every collapse in a freed-group journal, so the device copy is patched with
compact scatters instead of re-uploaded.

Two additions: ``max_depth`` is the deepest node depth the tree has held. The
visit closure (``adaptive.feedback.propagate_visits``) takes its pass count
from it instead of a fixed cap. And the patch journal (``PatchJournal``)
takes whole slot arrays beside spans (``mark_slots``), so an engine that
writes the buffers directly hands its patched slots over in one call, and
the drain expands, sorts and deduplicates them without a Python step a slot.
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


class PatchJournal:
    """The slots touched since the last drain: ``(start, stop)`` spans and
    arrays of single slots, in the order they were marked. ``len``, indexing
    and iteration read an array's slots as one ``(slot, slot + 1)`` span
    each, as if each had been marked alone."""

    def __init__(self):
        self._parts: list = []  # (start, stop) tuples and int32 slot arrays

    def mark(self, start: int, stop: int) -> None:
        self._parts.append((start, stop))

    def mark_slots(self, slots: np.ndarray) -> None:
        if len(slots):
            self._parts.append(np.array(slots, dtype=np.int32))

    def __bool__(self) -> bool:
        return bool(self._parts)

    def __len__(self) -> int:
        return sum(1 if isinstance(p, tuple) else p.size for p in self._parts)

    def __iter__(self):
        for part in self._parts:
            if isinstance(part, tuple):
                yield part
            else:
                yield from ((s, s + 1) for s in part.tolist())

    def __getitem__(self, key):
        return list(self)[key]

    def indices(self) -> np.ndarray:
        """Every journalled slot once, sorted, int32."""
        spans = [p for p in self._parts if isinstance(p, tuple)]
        slots = [p for p in self._parts if not isinstance(p, tuple)]
        if spans:
            start, stop = np.array(spans, dtype=np.int64).reshape(-1, 2).T
            n = np.maximum(stop - start, 0)
            # Slot k of the expansion is its span's start plus k less the
            # slots of the spans before it.
            base = np.repeat(start - (np.cumsum(n) - n), n)
            slots.append((base + np.arange(base.size)).astype(np.int32))
        return np.unique(np.concatenate(slots))


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
        self._dirty = PatchJournal()
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
        self._dirty.mark(start, stop)

    def mark_slots(self, slots: np.ndarray) -> None:
        """Journal every slot of ``slots`` as patched (for engines that write
        the buffers directly)."""
        self._dirty.mark_slots(slots)

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
        journal, self._dirty = self._dirty, PatchJournal()
        idx = journal.indices()
        return idx, self._nodes[idx]
