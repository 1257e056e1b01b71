"""Native adaptive engine: libotcore's batch subdivision and collapse over
the ``Octree``'s own buffers (the JAX package's ``app/native_engine.py``,
copied; tests hold it equal to ``adaptive.engine``).

The library writes the buffers directly, so the octree takes the slots it
patched as one array (``Octree.mark_slots``; the JAX package's bridge marks
them one at a time), learns the depth of the nodes it gained from their
positions (``Octree.note_depth``), and the child groups that collapses freed
from the hole stack. The JAX package's bridge journals no freed group, so
its ``Octree.drain_freed()`` is always empty under this engine.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from ..utils import timing


def _make_pool(octree, extra_capacity: int, extra_holes: int):
    with timing.span("engine.pool"):
        octree._grow(len(octree) + extra_capacity)
        holes = np.zeros(len(octree.hole_stack) + extra_holes + 1, dtype=np.uint32)
        if octree.hole_stack:
            holes[: len(octree.hole_stack)] = octree.hole_stack
        pool = native.OtPool(
            native._u32p(octree._nodes),
            native._f32p(octree._positions),
            np.uint64(len(octree)),
            np.uint64(octree._nodes.shape[0]),
            native._u32p(holes),
            np.uint64(len(octree.hole_stack)),
            np.uint64(holes.shape[0]),
        )
    return pool, holes


def _sync(octree, pool, holes, patches, n_patches):
    """Take the library's writes into the octree: its length, its hole stack
    and the patched slots, journalled as one array. A subdivision only pops
    holes off the top of the stack and a collapse only pushes them on, so
    the list is cut or extended, not rebuilt. Returns the holes pushed."""
    octree._len = int(pool.len)
    hole_len = int(pool.hole_len)
    pushed = holes[len(octree.hole_stack): hole_len].tolist()
    del octree.hole_stack[hole_len:]
    octree.hole_stack.extend(pushed)
    slots = patches[:n_patches]
    octree.mark_slots(slots)
    # A new child group is patched whole, its 8-aligned base among it; every
    # other patched slot is its sibling, its parent or a collapsed node the
    # tree held already, so no deeper.
    octree.note_depth(slots[slots % 8 == 0])
    return pushed


def process_subdivision(candidates, octree, world):
    """Returns (applied, missing_chunk_ids); missing chunks start loading."""
    with timing.span("engine.subdivide"):
        lib = native.load()
        cand = np.ascontiguousarray(candidates, dtype=np.int32)
        pool, holes = _make_pool(octree, 8 * cand.shape[0], 0)
        with timing.span("engine.views"):
            chunks, n_chunks, keep = native.chunk_views(world)

        patch_cap = 9 * cand.shape[0] + 8
        patches = np.zeros(patch_cap, dtype=np.uint32)
        n_patches = ctypes.c_uint64(0)
        missing = np.zeros(max(16, cand.shape[0]), dtype=np.uint32)
        n_missing = ctypes.c_uint64(0)

        with timing.span("engine.native"):
            applied = lib.otc_process_subdivision(
                ctypes.byref(pool),
                cand.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_uint64(cand.shape[0]),
                chunks, ctypes.c_uint64(n_chunks),
                native._u32p(patches), ctypes.byref(n_patches),
                ctypes.c_uint64(patch_cap),
                native._u32p(missing), ctypes.byref(n_missing),
                ctypes.c_uint64(missing.shape[0]),
            )
        with timing.span("engine.sync"):
            _sync(octree, pool, holes, patches, int(n_patches.value))
            missing_ids = np.unique(missing[: int(n_missing.value)])
            for mid in missing_ids:
                world.load_chunk(int(mid))
        return int(applied), missing_ids


def process_unsubdivision(candidates, octree, world):
    """Returns (applied, evicted_chunk_ids); generated chunks are evicted."""
    with timing.span("engine.collapse"):
        lib = native.load()
        cand = np.ascontiguousarray(candidates, dtype=np.int32)
        pool, holes = _make_pool(octree, 0, cand.shape[0])
        with timing.span("engine.views"):
            chunks, n_chunks, keep = native.chunk_views(world)

        patch_cap = cand.shape[0] + 8
        patches = np.zeros(patch_cap, dtype=np.uint32)
        n_patches = ctypes.c_uint64(0)
        evict = np.zeros(max(16, cand.shape[0]), dtype=np.uint32)
        n_evict = ctypes.c_uint64(0)

        with timing.span("engine.native"):
            applied = lib.otc_process_unsubdivision(
                ctypes.byref(pool),
                cand.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_uint64(cand.shape[0]),
                chunks, ctypes.c_uint64(n_chunks),
                native._u32p(patches), ctypes.byref(n_patches),
                ctypes.c_uint64(patch_cap),
                native._u32p(evict), ctypes.byref(n_evict),
                ctypes.c_uint64(evict.shape[0]),
            )
        with timing.span("engine.sync"):
            # Each collapse pushed its child group on the hole stack; journal
            # them as Octree.unsubdivide does, so the Session can drop stale
            # candidates.
            octree._freed.extend(_sync(octree, pool, holes, patches,
                                       int(n_patches.value)))
            evicted = np.unique(evict[: int(n_evict.value)])
            for eid in evicted:
                world.evict_chunk(int(eid))
        return int(applied), evicted
