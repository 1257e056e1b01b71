"""World: chunk store, mip trees, async chunk streaming, world generation
(the JAX package's ``world/world.py``, copied; tests hold it equal to the
original, and the files ``generate_world`` writes byte-equal to its).

A dict of ``CpuOctree`` chunks keyed by id (0 = root, 1..8 = block library,
>= CHUNK_OFFSET/2 = generated terrain), a thread pool for async chunk loads
and saves, and the mip generation as per-level NumPy passes or the native
library. Chunk files are ``<dir>/<id>.bin`` in ``cpu_octree.BIN_DTYPE``
layout. ``wait_for_loads`` is the port's addition, for runs that step two
Sessions in lockstep.

The block library is chunks 1-8, loaded from ``<asset_root>/blocks/<name>.vox``
(``BLOCK_NAMES``) with their mip trees, as the JAX ``World`` loads it.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from ..core.cpu_octree import CpuOctree
from ..core.voxel import CHUNK_OFFSET, child_offset
from ..utils import timing


BLOCK_NAMES = [
    "stone", "dirt", "grass", "wood", "leaf", "slate", "crystal", "glass",
]  # ids 1..8

# The directory that holds blocks/ and structures/ (and files/ for the CLI's
# bench scene): OT_ASSET_ROOT, read once, at import, as the JAX package reads
# it. There is no default; a caller may pass ``asset_root`` instead.
DEFAULT_ASSET_ROOT = os.environ.get("OT_ASSET_ROOT") or None


def resolve_asset_root(asset_root: str | None = None) -> str:
    """``asset_root`` if given, else ``OT_ASSET_ROOT`` as read at import.
    Raises FileNotFoundError when neither names a directory."""
    root = asset_root or DEFAULT_ASSET_ROOT
    if not root:
        raise FileNotFoundError(
            "no asset root: set OT_ASSET_ROOT or pass asset_root")
    return root


class World:
    """Chunk store with the 8-block library preloaded (``load_blocks``)."""

    def __init__(self, path: str = "", asset_root: str | None = None,
                 load_blocks: bool = True, verbose: bool = False):
        self.path = path
        # The port's: a Regenerate reuses it. None when neither it nor
        # OT_ASSET_ROOT is given; loading blocks then raises.
        self.asset_root = asset_root or DEFAULT_ASSET_ROOT
        self.chunks: dict[int, CpuOctree] = {}
        self.loading: set[int] = set()
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=2)
        self.verbose = verbose

        if load_blocks:
            from ..io import load_file

            root = resolve_asset_root(asset_root)
            for i, name in enumerate(BLOCK_NAMES, start=1):
                self.chunks[i] = load_file(os.path.join(root, "blocks", f"{name}.vox"))
                self.generate_mip_tree(i)

    @classmethod
    def load_world(cls, path: str, **kw) -> "World":
        """Read only the root chunk ``0.bin``; the rest streams in on
        demand."""
        world = cls(path, **kw)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(os.path.join(path, "0.bin"), "rb") as f:
            world.chunks[0] = CpuOctree.from_bin(f.read())
        return world

    def save_chunk(self, index: int) -> None:
        self.chunks[index].to_file(os.path.join(self.path, f"{index}.bin"))

    def load_chunk(self, index: int) -> None:
        """Async load; duplicate requests are coalesced."""
        with self._lock:
            if index in self.loading or index in self.chunks:
                return
            self.loading.add(index)
        step = timing.current_step()  # the requesting step's, for its span

        def work():
            try:
                with timing.span("world.load_chunk", step=step):
                    with open(os.path.join(self.path, f"{index}.bin"), "rb") as f:
                        chunk = CpuOctree.from_bin(f.read())
                with self._lock:
                    self.chunks[index] = chunk
            finally:
                with self._lock:
                    self.loading.discard(index)

        self._pool.submit(work)

    def wait_for_loads(self) -> None:
        """Block until every requested chunk load has finished (or
        failed)."""
        while True:
            with self._lock:
                if not self.loading:
                    return
            time.sleep(0.0005)

    def evict_chunk(self, index: int) -> None:
        if self.verbose:
            print(f"Destroyed chunk {index}")
        self.chunks.pop(index, None)

    def find_voxel(self, pos, max_depth: int | None = None):
        """Cross-chunk point location: follows ``ptr > CHUNK_OFFSET`` into
        the referenced chunk's root. Returns (chunk_id, index, depth,
        centre)."""
        pos = np.asarray(pos, dtype=np.float32)
        node_index = 0
        chunk = 0
        node_pos = np.zeros(3, dtype=np.float32)
        depth = 0
        while True:
            depth += 1
            p = (pos >= node_pos).astype(np.int64)
            child_index = int(p[0] * 4 + p[1] * 2 + p[2])
            node_pos = node_pos + child_offset(child_index, depth)
            tree = self.chunks[chunk]
            tnipt = int(tree.pointers[node_index + child_index])
            if tnipt == int(CHUNK_OFFSET) or depth == (max_depth or 2**31):
                return chunk, node_index + child_index, depth, node_pos
            elif tnipt > int(CHUNK_OFFSET):
                chunk = tnipt - int(CHUNK_OFFSET)
                node_index = 0
            else:
                node_index = tnipt

    def generate_mip_tree(self, chunk_id: int) -> None:
        """Rebuild the interior mip colours of a chunk: chunk-ref children
        take the referenced chunk's ``top_mip``, then non-empty children are
        averaged bottom-up with the >= 1 clamp, so filled parents never look
        empty."""
        tree = self.chunks[chunk_id]
        ptr = tree.pointers
        val = tree.values

        if native.available() and val.flags["C_CONTIGUOUS"]:
            # Patch every chunk-ref value once, then the C++ BFS + average
            # (equal to the NumPy path below; tests hold both to the JAX
            # package's).
            loaded = sorted((int(cid), int(c.top_mip)) for cid, c in self.chunks.items())
            if loaded:
                ids = np.fromiter((c for c, _ in loaded), dtype=np.uint32,
                                  count=len(loaded))
                mips = np.fromiter((m for _, m in loaded), dtype=np.uint32,
                                   count=len(loaded))
                native.patch_refs(ptr, val, ids, mips)
            tree.top_mip = np.uint32(native.mip_tree(ptr, val))
            return

        def patch_chunk_refs(indices: np.ndarray) -> None:
            refs = indices[ptr[indices] > CHUNK_OFFSET]
            if refs.size == 0:
                return
            ids = (ptr[refs] - CHUNK_OFFSET).astype(np.int64)
            for uid in np.unique(ids):
                chunk = self.chunks.get(int(uid))
                if chunk is not None:
                    val[refs[ids == uid]] = chunk.top_mip

        # levels[k] = interior node slots at depth k+1.
        top = np.arange(8, dtype=np.int64)
        patch_chunk_refs(top)
        levels = []
        frontier = top[ptr[top] < CHUNK_OFFSET]
        while frontier.size:
            levels.append(frontier)
            children = (ptr[frontier].astype(np.int64)[:, None]
                        + np.arange(8, dtype=np.int64)).reshape(-1)
            patch_chunk_refs(children)
            frontier = children[ptr[children] < CHUNK_OFFSET]

        def average(bases: np.ndarray) -> np.ndarray:
            childs = bases[:, None] + np.arange(8, dtype=np.int64)
            cv = val[childs]
            nonzero = cv != 0
            r = ((cv >> 16) & 0xFF).astype(np.float32)
            g = ((cv >> 8) & 0xFF).astype(np.float32)
            b = (cv & 0xFF).astype(np.float32)
            div = nonzero.sum(axis=1).astype(np.float32)
            out = np.empty((bases.shape[0], 3), dtype=np.uint32)
            for c, comp in enumerate((r, g, b)):
                s = (comp * nonzero).sum(axis=1)
                mean = np.where(div > 0, s / np.maximum(div, 1), 0.0)
                # Truncate to u8 (NaN -> 0), then clamp at 1.
                out[:, c] = np.maximum(mean.astype(np.uint32) & 0xFF, 1)
            return (out[:, 0] << 16) | (out[:, 1] << 8) | out[:, 2]

        for frontier in reversed(levels):
            val[frontier] = average(ptr[frontier].astype(np.int64))
        tree.top_mip = np.uint32(average(np.zeros(1, dtype=np.int64))[0])

    def generate_world(self, path: str, procedural, world_depth: int = 1,
                       progress=None) -> None:
        """Generate a (2^world_depth)^3 grid of terrain chunks, mip and save
        each, and assemble the root chunk of chunk references.

        A three-way pipeline: the device computes chunk i+1's grid while the
        host builds chunk i's tree, and each finished chunk's disk write and
        free run on the IO pool."""
        os.makedirs(path, exist_ok=True)
        self.path = path
        root = CpuOctree(0)
        world_size = 1 << world_depth
        voxel_size = 2.0 / world_size
        cells = [(x, y, z) for x in range(world_size) for y in range(world_size)
                 for z in range(world_size)]

        def cell_pos(cell):
            return np.array(cell, dtype=np.float32) * voxel_size - 1.0

        def save_and_free(index):
            self.save_chunk(index)
            self.chunks[index].free_nodes()

        saves = []
        handle = procedural.dispatch_chunk(cell_pos(cells[0]), world_depth)
        for i, cell in enumerate(cells):
            nxt = (procedural.dispatch_chunk(cell_pos(cells[i + 1]), world_depth)
                   if i + 1 < len(cells) else None)
            chunk = procedural.finish_chunk(handle)
            handle = nxt
            index = int(CHUNK_OFFSET) // 2 + i
            if chunk is not None:
                if self.verbose:
                    print(f"{cell}: {len(chunk) / 1e6:.1f} million nodes")
                self.chunks[index] = chunk
                self.generate_mip_tree(index)
                saves.append(self._pool.submit(save_and_free, index))
                root.put_in_block(cell_pos(cell), index, world_depth)
            if progress:
                progress(i + 1, world_size ** 3)
        for f in saves:
            f.result()  # raise IO errors before the world counts as done
        self.chunks[0] = root
        self.generate_mip_tree(0)
        self.save_chunk(0)
