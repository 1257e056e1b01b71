"""The adaptive streaming Session over a mesh of ranks (the port of the JAX
package's ``parallel/session.py``).

Design: rank 0 is the only host controller. JAX drives every chip from one
process; ``torch.distributed`` runs a process a rank, and the world loads
chunks on a thread pool (``World.load_chunk``) that the engine polls and
retries frame by frame, so engines on several ranks would diverge as soon
as a load landed on one rank before another. So:

- rank 0 alone owns the world, the host ``Octree``, the engine, candidate
  selection (K5) and the visit closure (K6), and inherits every repair of
  the port's ``Session``;
- every rank holds the device pool and the warp table, replicated, and
  changes them only by the operations rank 0 records: a whole pool (a full
  upload or a change of bucket), a patch batch, table cells zeroed, the
  skip half zeroed, a table built or its skip half rebuilt. The builds are
  deterministic functions of the pool, so each rank runs them itself
  rather than receive the table;
- ``render`` broadcasts one frame message from rank 0: the operations of
  ``_auto_warp``, the inverse camera matrix (16 f32), the sun and the
  frame's flags. Every rank then generates the whole frame's rays (K3) and
  traces its own rows (``render_frame_sharded``); the visits are summed on
  every rank and rank 0 keeps them;
- ``update`` runs the inherited adaptive pass on rank 0 and broadcasts one
  step message: its operations and payloads (patch indices and words, a
  whole pool), the step's stats, the node count and hole share, the
  selection offset and the frame count. Every rank applies it and returns
  the same stats.

A message is an int64 head of fixed length (purpose, payload length, the
operations, the scalars), then, when there is any, one int32 payload of
every operation's data in order. Deferred feedback composes unchanged: its
pending selection lives on rank 0. Every rank calls ``render``, ``update``
(or ``step``), ``reset_world`` and ``reset_scene`` in the same order; a
rank that reads a message of another purpose raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..app.session import DEFAULT_POOL_CAPACITY, Character, Session, Settings
from ..render import camera
from . import mesh as pmesh

# Operations on the replicated device state, in the order rank 0 ran them.
POOL, PATCH, ZERO_CELLS, ZERO_SKIP, BUILD_COMBINED, BUILD_WARP, REBUILD_SKIP = range(1, 8)
MAX_OPS = 12  # an update runs at most 6 (two feedback batches)
# Message purposes; a rank reading another purpose than it expects raises.
INIT, FRAME, STEP, RESET = range(1, 5)
_SCALARS = 32
_HEAD = 3 + 2 * MAX_OPS + _SCALARS  # purpose, payload words, op count, ops, scalars
_FLAGS = ("shadows", "show_steps", "show_hits", "with_visits", "misc_bool", "visit_flags")
_STATS = ("subdivided", "collapsed", "patched")


def _f32_bits(values) -> list[int]:
    return np.asarray(values, np.float32).reshape(-1).view(np.int32).tolist()


def _from_bits(values) -> np.ndarray:
    return np.asarray(values, np.int64).astype(np.int32).view(np.float32)


class ShardedSession(Session):
    """Session whose frames render row-sharded over a ``parallel.Mesh``,
    with rank 0 as the host controller (see the module docstring).

    Every rank constructs it with the same sizes and settings; only rank
    0's ``world`` is read (other ranks may pass None). The device is the
    mesh's."""

    def __init__(self, world, mesh: pmesh.Mesh, width=1280, height=720,
                 pool_capacity=DEFAULT_POOL_CAPACITY, settings=None,
                 use_native: bool | None = None):
        if height % mesh.size:
            raise ValueError(f"height {height} not divisible by mesh size {mesh.size}")
        self.mesh = mesh
        self._ops: list[tuple[int, torch.Tensor | None]] = []
        if mesh.rank == 0:
            super().__init__(world, width, height, pool_capacity, settings, use_native,
                             device=mesh.device)
        else:
            self.world = None
            self.octree = None
            self.device = mesh.device
            self.settings = settings or Settings()
            self.use_native = False
            self.character = Character()
            self.width, self.height = width, height
            self.pool_capacity = pool_capacity
            self.device_words = None
            self._warp_table = None
            self._last_visits = None
            self._pending_feedback = None
            self.frame_count = 0
            self.stale_dropped = 0
            self._sel_offset = 0
        self._node_stats = (0, 0.0)
        self._end_step(self._sync(INIT, self._state_scalars()))

    # -- operations on the replicated state, recorded on rank 0 -------------

    def _full_upload(self):
        super()._full_upload()
        self._ops.append((POOL, self.device_words))

    def _patch_pool(self, idx, vals):
        super()._patch_pool(idx, vals)
        # drain_patches gives each slot once, all >= 0.
        self._ops.append((PATCH, torch.from_numpy(np.concatenate(
            [idx.astype(np.int32), vals.astype(np.uint32).view(np.int32)]))))

    def _zero_table_cells(self, flat):
        super()._zero_table_cells(flat)
        self._ops.append((ZERO_CELLS, torch.from_numpy(flat.astype(np.int32))))

    def _zero_skip_half(self):
        super()._zero_skip_half()
        self._ops.append((ZERO_SKIP, None))

    def _build_table(self, combined):
        super()._build_table(combined)
        self._ops.append((BUILD_COMBINED if combined else BUILD_WARP, None))

    def _rebuild_skip_half(self):
        super()._rebuild_skip_half()
        self._ops.append((REBUILD_SKIP, None))

    def _apply(self, code: int, data: torch.Tensor) -> None:
        """Replay one of rank 0's operations on this rank's replica."""
        if code == POOL:
            self.device_words = data.clone()
        elif code == PATCH:
            k = data.shape[0] // 2
            words = self.device_words.clone()
            words[data[:k].long()] = data[k:]
            self.device_words = words
        elif code == ZERO_CELLS:
            self._warp_table[data.long()] = 0
        elif code == ZERO_SKIP:
            Session._zero_skip_half(self)
        elif code in (BUILD_COMBINED, BUILD_WARP):
            Session._build_table(self, code == BUILD_COMBINED)
        elif code == REBUILD_SKIP:
            Session._rebuild_skip_half(self)
        else:
            raise ValueError(f"unknown operation {code}")

    # -- messages -----------------------------------------------------------

    def _sync(self, purpose: int, scalars=()) -> list[int]:
        """Broadcast rank 0's recorded operations and ``scalars`` (int64s);
        other ranks apply the operations. Returns the scalars on every
        rank."""
        mesh = self.mesh
        head = torch.zeros(_HEAD, dtype=torch.int64)
        if mesh.rank == 0:
            ops, self._ops = self._ops, []
            if len(ops) > MAX_OPS or len(scalars) > _SCALARS:
                raise RuntimeError(f"{len(ops)} operations and {len(scalars)} scalars "
                                   f"overflow a message")
            sizes = [0 if d is None else int(d.shape[0]) for _, d in ops]
            head[:3] = torch.tensor([purpose, sum(sizes), len(ops)])
            for i, ((code, _), n) in enumerate(zip(ops, sizes)):
                head[3 + 2 * i: 5 + 2 * i] = torch.tensor([code, n])
            head[3 + 2 * MAX_OPS: 3 + 2 * MAX_OPS + len(scalars)] = torch.tensor(
                list(scalars), dtype=torch.int64)
        head = mesh.broadcast(_to_device(head, mesh.device), "message_head")
        if mesh.rank == 0:
            payload = [_to_device(d, mesh.device) for _, d in ops if d is not None]
            if payload:
                mesh.broadcast(torch.cat(payload), "message_payload")
            return list(scalars)
        head = head.tolist()
        if head[0] != purpose:
            raise RuntimeError(f"rank {mesh.rank} expected message {purpose}, "
                               f"rank 0 sent {head[0]}: ranks out of step")
        n_payload, n_ops = head[1], head[2]
        payload = None
        if n_payload:
            payload = mesh.broadcast(torch.empty(n_payload, dtype=torch.int32,
                                                 device=mesh.device), "message_payload")
        at = 0
        for i in range(n_ops):
            code, n = head[3 + 2 * i: 5 + 2 * i]
            self._apply(code, None if n == 0 else payload[at:at + n])
            at += n
        return head[3 + 2 * MAX_OPS:]

    # -- frame loop -----------------------------------------------------------

    def render(self):
        """Render one frame sharded over the mesh; every rank returns the
        whole (image u8[H, W, 3], TraceResult in pixel order)."""
        scalars = ()
        if self.mesh.rank == 0:
            cam_inv, warp, args = self._plan_frame()
            scalars = (_f32_bits(cam_inv) + _f32_bits(args["sun_dir"])
                       + [int(args[k]) for k in _FLAGS] + [int(warp is not None)])
        scalars = self._sync(FRAME, scalars)
        cam_inv = _from_bits(scalars[:16]).reshape(4, 4)
        args = dict(zip(_FLAGS, map(bool, scalars[19:25])))
        args["sun_dir"] = _from_bits(scalars[16:19])
        warp = self._warp_table if scalars[25] else None
        origin, dirs = camera.generate_rays_device(cam_inv, self.width, self.height,
                                                   self.device)
        img, result, visits = pmesh.render_frame_sharded(
            self.mesh, self.device_words, origin, dirs, u8_image=True, warp_table=warp,
            **args)
        self._last_visits = visits if self.mesh.rank == 0 else None
        return img, result

    def update(self):
        """The adaptive pass on rank 0, its operations replayed on every
        rank; every rank returns rank 0's stats."""
        stats = super().update() if self.mesh.rank == 0 else None
        return self._end_step(self._sync(STEP, self._state_scalars(stats)))

    def _state_scalars(self, stats=None) -> list[int]:
        """Rank 0's step stats and the host scalars a step message carries
        (nothing on other ranks)."""
        if self.mesh.rank != 0:
            return []
        stats = stats or {k: 0 for k in _STATS}
        n, holes = super().node_stats()
        return ([stats[k] for k in _STATS]
                + [n, int(np.float64(holes).view(np.int64)), self._sel_offset,
                   self.frame_count, self.stale_dropped])

    def _end_step(self, scalars) -> dict:
        """Take a step message's host scalars; returns its stats."""
        n, holes, self._sel_offset, self.frame_count, self.stale_dropped = scalars[3:8]
        self._node_stats = (n, float(np.int64(holes).view(np.float64)))
        return dict(zip(_STATS, scalars[:3]))

    def reset_world(self, world) -> None:
        """Collective: rank 0 swaps in ``world`` (other ranks may pass None)
        and every rank takes its pool."""
        if self.mesh.rank == 0:
            super().reset_world(world)
        self._end_step(self._sync(RESET, self._state_scalars()))

    def reset_scene(self, chunk) -> None:
        """Collective: rank 0 swaps in the root ``chunk`` (other ranks may
        pass None)."""
        if self.mesh.rank == 0:
            super().reset_scene(chunk)  # calls reset_world, which syncs
        else:
            self.reset_world(None)

    def node_stats(self):
        """(node count, hole %) of rank 0's octree, on every rank, as of the
        last update."""
        if self.mesh.rank == 0:
            return super().node_stats()
        return self._node_stats


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor goes to a card through pinned
    memory, without waiting for the stream."""
    if t.device == device:
        return t
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
