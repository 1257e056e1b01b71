"""Interactive rendering session: the per-frame adaptive streaming loop (the
port of the JAX package's ``app/session.py``).

A step renders with visit counting on the device, selects LOD candidates on
the device (K5, after the visit closure K6 when the frame rode a warp/skip
table), reads back the compact candidate lists, runs the host engine against
the world, and patches the device pool with the octree's journal.

Differences from the JAX Session:

- an explicit ``device``, the card by default: the kernels run on a CUDA
  device, their plain versions on the CPU only when the caller passes
  ``device="cpu"``; without a card the default raises;
- the result comes back in pixel order (no beam mode, ``raw_result`` or
  ``pre_permuted``);
- deferred feedback reads the packed candidates back with a non-blocking
  copy into pinned host memory and a CUDA event, and waits on that event
  before the next step reads them;
- stale candidates: the slots freed by the batch just applied are always
  dropped from a deferred selection. The JAX Session drops them only when
  the pool crossed a bucket (``session.py:510-514``), so a selection can
  subdivide a slot of a group that batch freed, leaking the group;
- the visit closure runs ``Octree.max_depth + 1`` passes, the depth of the
  tree it closes, where the JAX Session caps them at
  ``min(24, octree_depth + 2)`` (``session.py:522``);
- a counted frame that rides the combined table's skip half marks, at every
  skip jump, the empty leaf of each table cell the jump crosses
  (``tracer._jump_slots``, K1's ``mark_jump``), so the closure leaves the
  interiors a root descent reads: the JAX Session's jumps mark nothing and
  it lists the interiors only they cross to collapse, which the reference
  rule does not. Each such jump also counts the boundary steps a root
  descent takes across it (the same walk), where JAX's counts
  one, and shrinks near the step cap, so the frame forces the rays the
  reference forces, at its positions: with one step a jump, late fly-in
  frames left thousands of grazing rays short of the cap, whose hits and
  shadows then moved pixels and candidates.

The device-pool bucket ladder stays: the selection's index modulus, its
rotation offset and the warp eligibility all read the device pool's length,
so a Session without the ladder would select differently.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, native
from ..adaptive import engine, feedback
from ..core.octree import Octree, node_depth
from ..render import camera, skip, tracer
from ..state import u32_to_device
from ..utils import timing
from . import native_engine

DEFAULT_POOL_CAPACITY = 10_000_000  # nodes
MAX_PATCH_WORDS = 1_048_576  # larger diffs take a full upload
WARP_LEVELS = 7  # the Session's table level
_NO_STATS = {"subdivided": 0, "collapsed": 0, "patched": 0}


class Character:
    """Fly camera."""

    def __init__(self):
        self.pos = np.array([0.1, 0.2, -1.5], dtype=np.float32)
        self.look = np.array([0.0, 0.0, 1.5], dtype=np.float32)
        self.speed = -5.0

    def move(self, forward=0.0, right=0.0, up=0.0):
        f = self.look / np.linalg.norm(self.look)
        r = np.cross(f, [0.0, 1.0, 0.0])
        r = r / np.linalg.norm(r)
        u = np.cross(r, f)
        step = np.float32(np.exp(self.speed))
        self.pos = self.pos + (f * forward + r * right + u * up) * step

    def turn(self, dx: float, dy: float, sensitivity=0.00005, fov=90.0):
        """Yaw/pitch by axis-angle rotations."""
        f = self.look / np.linalg.norm(self.look)
        r = np.cross(f, [0.0, 1.0, 0.0])
        r = r / np.linalg.norm(r)
        ax, ay = -dx * sensitivity * fov, -dy * sensitivity * fov

        def rot(v, axis, ang):
            axis = axis / np.linalg.norm(axis)
            c, s = np.cos(ang), np.sin(ang)
            return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c)

        look = rot(self.look, r, ay)
        look = rot(look, np.array([0.0, 1.0, 0.0]), ax)
        self.look = (look / np.linalg.norm(look)).astype(np.float32)


class Settings:
    """Runtime knobs, with the JAX Session's defaults."""

    def __init__(self):
        self.octree_depth = 12
        self.fov = 90.0
        self.sensitivity = 0.00005
        self.sun_dir = np.array([-1.7, -1.0, 0.8], dtype=np.float32)
        self.shadows = True
        self.show_steps = False
        self.show_hits = False
        self.pause_adaptive = False
        self.misc_value = 0.0
        self.misc_bool = False  # >= descent + gamma 1.0
        self.sub_cap = 65536    # per-frame candidate caps
        self.unsub_cap = 65536
        # Count visits and run the adaptive pass every Nth frame.
        self.feedback_every = 1
        # Counted frames record 0/1 flags plus exact filled-leaf counts (the
        # adaptive decisions equal exact counting's); show_hits forces counts.
        self.visit_flags = True
        # Consume a counted frame's candidates at the start of the next step.
        self.deferred_feedback = True
        # Device pools of at least this many words ride a level-7 warp table
        # (None disables); counted frames then take the visit closure.
        self.warp_pool_words = 1 << 20
        # Build that table in its combined warp+skip form (pools of at most
        # 2^23 words).
        self.skip_field = True


class Session:
    """Streaming renderer: world + host octree + device pool + camera."""

    def __init__(self, world, width=1280, height=720,
                 pool_capacity=DEFAULT_POOL_CAPACITY, settings=None,
                 use_native: bool | None = None, device="cuda"):
        self.world = world
        self.device = kernels.resolve_device(device)
        self.settings = settings or Settings()
        self.use_native = native.available() if use_native is None else use_native
        self.character = Character()
        self.width = width
        self.height = height
        self.pool_capacity = pool_capacity
        self.octree = Octree(world.chunks[0].get_node_mask(0))
        self._warp_table = None
        self._warp_dirty = True
        self._skip_stale = False
        self._warp_invalid = 0
        self._warp_incremental = 0  # incremental invalidations taken
        self._full_upload()
        self._last_visits = None
        self._pending_feedback = None
        self._last_freed = np.zeros(0, dtype=np.int64)
        self._frame_warped = False
        self.frame_count = 0
        self.stale_dropped = 0  # deferred candidates dropped as stale
        # Rotating selection offset: advances past each frame's consumed
        # window on cap overflow, so high slots are not starved.
        self._sel_offset = 0

    # -- device pool ---------------------------------------------------------

    def _device_bucket(self) -> int:
        """Device-pool length covering the live nodes, on the ladder
        64K/256K/1M/4M words, then the capacity."""
        n = max(1, len(self.octree))
        for b in (1 << 16, 1 << 18, 1 << 20, 1 << 22):
            if n <= b <= self.pool_capacity:
                return b
        return self.pool_capacity

    def _full_upload(self):
        self.device_words = u32_to_device(self.octree.expanded(self._device_bucket()),
                                          self.device)
        self._warp_dirty = True
        self.octree.drain_patches()

    def _push_patches(self):
        with timing.span("session.patches"):
            idx, vals = self.octree.drain_patches()
            timing.count("session.patched_slots", idx.size)
            if idx.size == 0:
                return 0
            if idx.size > MAX_PATCH_WORDS or len(self.octree) > self.device_words.shape[0]:
                self._full_upload()  # too many patches, or the pool left its bucket
                return idx.size
            self._patch_pool(idx, vals)
            self._invalidate_warp(idx)
            return idx.size

    def _patch_pool(self, idx: np.ndarray, vals: np.ndarray) -> None:
        self.device_words = feedback.apply_patches(self.device_words, idx, vals)

    # -- warp table ----------------------------------------------------------

    def _invalidate_warp(self, idx: np.ndarray) -> None:
        """Zero the warp words of the table cells inside each patched slot's
        cell instead of rebuilding the table. A stored resume state goes
        stale only when its node's slot is freed, which happens only below a
        collapsed node, whose own slot is patched and whose cell holds every
        freed descendant; a zeroed cell reads as invalid and restarts at the
        root, exactly. Large batches and shallow nodes mark the table for a
        rebuild instead."""
        if self._warp_table is None or self._warp_dirty:
            self._warp_dirty = True
            return
        levels = tracer.warp_table_levels(self._warp_table)
        side = 1 << levels
        pos = self.octree.positions[idx]
        depth = node_depth(pos)
        k = np.where(depth >= levels, 1, 1 << np.maximum(levels - depth, 0))
        if k.max(initial=1) > 64 or int(np.sum(k ** 3)) > (1 << 19):
            self._warp_dirty = True
            return
        lo = np.clip(np.floor((pos - (2.0 ** -depth)[:, None] + 1.0) * (side / 2.0)
                              ).astype(np.int64), 0, side - 1)
        cells = []
        for kk in np.unique(k):
            sel = lo[k == kk]
            off = np.arange(kk, dtype=np.int64)
            ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
            ex = np.clip(sel[:, None, 0] + ox.reshape(-1)[None, :], 0, side - 1)
            ey = np.clip(sel[:, None, 1] + oy.reshape(-1)[None, :], 0, side - 1)
            ez = np.clip(sel[:, None, 2] + oz.reshape(-1)[None, :], 0, side - 1)
            cells.append(((ex * side + ey) * side + ez).reshape(-1))
        flat = np.unique(np.concatenate(cells))
        if tracer.warp_table_combined(self._warp_table):
            flat = flat * 2  # warp word of cell c at 2c; the skip half is
            # zeroed whole after collapses (_apply_feedback)
        self._zero_table_cells(flat)
        self._warp_incremental += 1
        self._warp_invalid += int(flat.size)
        if self._warp_invalid > (side ** 3) // 16:
            self._warp_dirty = True  # too many root restarts: rebuild

    def _zero_table_cells(self, flat: np.ndarray) -> None:
        self._warp_table[torch.from_numpy(flat).to(self.device)] = 0

    def _zero_skip_half(self) -> None:
        self._warp_table[1::2] = 0

    def _build_table(self, combined: bool) -> None:
        build = skip.build_warp_skip_table if combined else tracer.build_warp_table
        with timing.span("session.warp_build"):
            timing.count("session.warp_builds")
            self._warp_table = build(self.device_words, WARP_LEVELS)

    def _rebuild_skip_half(self) -> None:
        """The current pool's skip words into the table's odd words in
        place (K2 and K12 on the card); the warp words stay."""
        levels = tracer.warp_table_levels(self._warp_table)
        with timing.span("session.skip_rebuild"):
            timing.count("session.skip_rebuilds")
            skip.build_skip_field(self.device_words, levels, table=self._warp_table)

    def _auto_warp(self, adaptive: bool):
        """The frame's warp table, or None: pools below
        ``Settings.warp_pool_words``, and show_hits frames that count (the
        view shows raw interior counts, which restarts change). Built lazily
        at level 7, combined with the skip field on pools of at most 2^23
        words; a stale skip half (after collapses) is rebuilt here."""
        s = self.settings
        if ((adaptive and s.show_hits) or s.warp_pool_words is None
                or self.device_words.shape[0] < s.warp_pool_words):
            return None
        if self._warp_dirty or self._warp_table is None:
            self._build_table(s.skip_field and self.device_words.shape[0] <= (1 << 23))
            self._warp_dirty = False
            self._skip_stale = False
            self._warp_invalid = 0
        elif self._skip_stale:
            self._rebuild_skip_half()
            self._skip_stale = False
        return self._warp_table

    # -- frame loop ----------------------------------------------------------

    def reset_scene(self, chunk) -> None:
        """Swap in a new root chunk and reset the streamed octree."""
        self.world.chunks[0] = chunk
        self.world.generate_mip_tree(0)
        self.reset_world(self.world)

    def reset_world(self, world) -> None:
        """Swap the whole world, reset the streamed octree and drop in-flight
        feedback (its candidates index the old tree)."""
        self.world = world
        self.octree = Octree(world.chunks[0].get_node_mask(0))
        self._pending_feedback = None
        self._last_visits = None
        self._full_upload()

    def _plan_frame(self):
        """(inverse camera matrix f32[4, 4], warp table or None, the
        frame's ``render_frame`` settings) of the next frame, building or
        refreshing the table; sets the counted-frame state ``update``
        reads."""
        s = self.settings
        with timing.span("session.plan"):
            _, cam_inv = camera.camera_matrices(self.character.pos, self.character.look,
                                                s.fov, self.width, self.height)
            adaptive = not s.pause_adaptive and (
                s.feedback_every <= 1 or self.frame_count % s.feedback_every == 0)
            warp = self._auto_warp(adaptive)
            # Every frame says whether its table carries a live skip half.
            timing.count("session.skip_live",
                         warp is not None and tracer.warp_table_combined(warp))
        self._frame_warped = adaptive and warp is not None
        # The pool the frame reads; patches replace device_words, not this.
        self._frame_words = self.device_words
        args = dict(sun_dir=np.asarray(s.sun_dir, np.float32), shadows=s.shadows,
                    show_steps=s.show_steps, show_hits=s.show_hits, with_visits=adaptive,
                    misc_bool=s.misc_bool,
                    visit_flags=adaptive and s.visit_flags and not s.show_hits)
        return cam_inv, warp, args

    def render(self):
        """Render one frame; returns (image u8[H, W, 3], TraceResult in
        pixel order), both on the session's device."""
        with timing.span("session.render"):
            cam_inv, warp, args = self._plan_frame()
            origin, dirs = camera.generate_rays_device(cam_inv, self.width, self.height,
                                                       self.device)
            img, result, visits = tracer.render_frame(
                self._frame_words, origin, dirs, u8_image=True, warp_table=warp, **args)
        self._last_visits = visits
        return img, result

    def update(self):
        """Post-render adaptive pass. With ``Settings.deferred_feedback`` the
        counted frame only dispatches candidate selection; the previous
        counted frame's readback, host engine and patch upload run here
        first."""
        with timing.span("session.update"):
            return self._update()

    def _update(self):
        s = self.settings
        stats = None
        freed_now = np.zeros(0, dtype=np.int64)
        if self._pending_feedback is not None:
            packed, ready, sel_offset, sel_m, caps, stale = self._pending_feedback
            self._pending_feedback = None
            with timing.span("session.readback_wait"):
                if ready is not None:
                    ready.synchronize()
                packed = packed.numpy()
            stats = self._apply_feedback(packed, sel_offset, sel_m, caps, stale)
            # Slots the batch just applied freed: this frame's visits were
            # counted before it, so candidates landing there are stale.
            freed_now = self._last_freed
        if s.pause_adaptive or self._last_visits is None:
            self.frame_count += 1
            return stats or dict(_NO_STATS)

        with timing.span("session.select"):
            # Select against the current pool (post-apply) when it kept its
            # bucket, else against the frame's pool.
            sel_words = self.device_words
            if sel_words.shape != self._frame_words.shape:
                sel_words = self._frame_words
            visits = self._last_visits
            if self._frame_warped:
                # The exact interior zero-set of a frame that rode the table,
                # closed over the tree the frame was traced on.
                visits = feedback.propagate_visits(self._frame_words, visits,
                                                   passes=self.octree.max_depth + 1)
            packed = feedback.select_candidates_packed(
                sel_words, visits, min(len(self.octree), int(sel_words.shape[0])),
                sub_cap=s.sub_cap, unsub_cap=s.unsub_cap, offset=self._sel_offset)
            ready = None
            if s.deferred_feedback and packed.is_cuda:
                host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                host.copy_(packed, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
                packed = host
        self._last_visits = None
        sel_m = int(sel_words.shape[0])
        caps = (s.sub_cap, s.unsub_cap)
        if s.deferred_feedback:
            self._pending_feedback = (packed, ready, self._sel_offset, sel_m, caps,
                                      freed_now)
            self.frame_count += 1
            return stats or dict(_NO_STATS)
        with timing.span("session.readback_wait"):
            packed = packed.cpu().numpy()
        now = self._apply_feedback(packed, self._sel_offset, sel_m, caps, freed_now)
        if stats:  # a pending batch applied this step too
            now = {k: stats[k] + now[k] for k in now}
        self.frame_count += 1
        return now

    def _apply_feedback(self, packed: np.ndarray, sel_offset: int, m: int,
                        caps: tuple, stale: np.ndarray):
        """Consume a packed candidate readback: host engine, then patches.
        ``sel_offset``, ``m`` and ``caps`` are the selection's rotation
        offset, index modulus and caps; ``stale`` the slots freed since its
        visits were counted, whose candidates no longer name live nodes."""
        with timing.span("session.engine"):
            sub_cap, unsub_cap = caps
            sub_n, unsub_n = int(packed[0]), int(packed[1])
            sub_idx = packed[2: 2 + min(sub_n, sub_cap)]
            unsub_idx = packed[2 + sub_cap: 2 + sub_cap + min(unsub_n, unsub_cap)]
            timing.count("engine.sub_read", sub_idx.size)

            # On cap overflow, move the window just past the last candidate
            # consumed (stale ones count: they were looked at).
            def _consumed(idx, count, cap):
                if count <= cap or idx.size == 0:
                    return 0
                return (int(idx[-1]) - sel_offset) % m + 1
            adv = max(_consumed(sub_idx, sub_n, sub_cap),
                      _consumed(unsub_idx, unsub_n, unsub_cap))
            if adv:
                self._sel_offset = (sel_offset + adv) % m

            if stale.size:
                keep_sub = ~np.isin(sub_idx, stale)
                keep_unsub = ~np.isin(unsub_idx, stale)
                self.stale_dropped += int((~keep_sub).sum() + (~keep_unsub).sum())
                sub_idx, unsub_idx = sub_idx[keep_sub], unsub_idx[keep_unsub]

            if self.use_native:
                subdivided, _ = native_engine.process_subdivision(sub_idx, self.octree,
                                                                  self.world)
                collapsed, _ = native_engine.process_unsubdivision(unsub_idx, self.octree,
                                                                   self.world)
            else:
                subdivided = engine.process_subdivision(sub_idx, self.octree, self.world)
                collapsed = engine.process_unsubdivision(unsub_idx, self.octree, self.world)
            timing.count("engine.subdivided", subdivided)
        patched = self._push_patches()
        if (collapsed and self._warp_table is not None and not self._warp_dirty
                and not self._skip_stale
                and tracer.warp_table_combined(self._warp_table)):
            # A collapse fills cells that stored skip cubes may cover: zero
            # the skip half (the table stays valid as warp-only) and rebuild
            # it on the next frame that takes the table.
            self._zero_skip_half()
            self._skip_stale = True
        self._last_freed = self.octree.drain_freed()
        return {"subdivided": subdivided, "collapsed": collapsed, "patched": patched}

    def step(self):
        """render + update, one turn of the outer event loop."""
        img, result = self.render()
        stats = self.update()
        return img, result, stats

    def node_stats(self):
        """(node count, hole %)."""
        return len(self.octree), 100.0 * self.octree.hole_fraction()
