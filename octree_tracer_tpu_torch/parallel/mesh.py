"""Row-sharded frames over ``torch.distributed`` (the port of the JAX
package's ``parallel/mesh.py``).

JAX shards a frame's pixel rows over a 1-D ``rays`` mesh with ``shard_map``
from one host process, replicates the pool and the warp table, and ``psum``s
the visit counts. Here each rank is a process of its own with one device:

- every rank holds the pool and the table (``replicate`` broadcasts rank
  0's copy);
- ``render_frame_sharded`` traces the rank's block of rows through the
  port's ``render_frame`` (K1 takes a row block as it is: its 8x4 tiles clip
  at the block's last row), then ``all_reduce``s the visits (SUM, int32:
  0/1 flags sum to the union's zero-set, the exact filled-leaf overlays to
  exact counts) and ``all_gather``s the image and the ``TraceResult`` in row
  order, so every rank returns the whole frame, as JAX's global arrays read.

No kernel of its own: the row block goes through K1-K4. Each collective's
bytes are counted on the mesh (``Mesh.traffic``), by purpose.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import kernels
from ..render import tracer

# Every TraceResult field travels as int32 columns of one tensor (bools as
# 0/1, f32 as their bits), in this order, so a frame takes one all-gather.
_FIELD_COLUMNS = (("hit", 1), ("forced", 1), ("index", 1), ("hit_pos", 3),
                  ("normal", 3), ("steps", 1), ("depth", 1), ("word", 1))


class Mesh:
    """A 1-D mesh of ranks over one process group: this process's rank, the
    group's size, this rank's device, and the axis name JAX's mesh has.

    ``traffic`` maps a collective's purpose to its calls, total bytes and
    largest call's bytes on this rank."""

    axis = "rays"

    def __init__(self, group, rank: int, size: int, device: torch.device, src: int):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.src = src  # global rank of the group's rank 0
        self.traffic: dict[str, dict[str, int]] = {}

    def count(self, purpose: str, nbytes: int) -> None:
        t = self.traffic.setdefault(purpose, {"calls": 0, "bytes": 0, "max_bytes": 0})
        t["calls"] += 1
        t["bytes"] += nbytes
        t["max_bytes"] = max(t["max_bytes"], nbytes)

    def broadcast(self, t: torch.Tensor, purpose: str) -> torch.Tensor:
        """Rank 0's ``t`` into ``t`` on every rank, in place."""
        dist.broadcast(t, self.src, group=self.group)
        self.count(purpose, t.numel() * t.element_size())
        return t


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (the default group when None), which must be
    initialised. This rank's device is ``device``, else
    ``cuda:{rank % device_count}``; ``"cpu"`` runs the plain versions."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group (or parallel.launch.run_ranks) first")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        kernels.resolve_device("cuda")  # raises without a card
        device = torch.device("cuda", rank % torch.cuda.device_count())
    src = 0 if group is None else dist.get_global_rank(group, 0)
    return Mesh(group, rank, size, kernels.resolve_device(device), src)


def replicate(mesh: Mesh, x: torch.Tensor | None) -> torch.Tensor:
    """Rank 0's tensor ``x`` on every rank, on the rank's device. Other
    ranks may pass None: the shape and dtype come from rank 0."""
    dtypes = (torch.int32, torch.int64, torch.float32, torch.float64, torch.uint8)
    head = torch.zeros(10, dtype=torch.int64, device=mesh.device)
    if mesh.rank == 0:
        if x.dim() > 8:
            raise ValueError(f"replicate takes at most 8 dimensions, not {x.dim()}")
        head[0] = dtypes.index(x.dtype)
        head[1] = x.dim()
        head[2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    mesh.broadcast(head, "replicate")
    code, ndim, *shape = head.tolist()
    dtype = dtypes[code]
    shape = shape[:ndim]
    if mesh.rank == 0:
        out = x.to(mesh.device).contiguous()
    else:
        out = torch.empty(shape, dtype=dtype, device=mesh.device)
    return mesh.broadcast(out, "replicate")


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s rows (leading axis), as a
    view."""
    h = x.shape[0]
    if h % mesh.size:
        raise ValueError(f"height {h} not divisible by mesh size {mesh.size}")
    rows = h // mesh.size
    return x[mesh.rank * rows:(mesh.rank + 1) * rows]


def all_reduce_visits(mesh: Mesh, visits: torch.Tensor) -> torch.Tensor:
    """Sum ``visits`` (int32[pool]) over the ranks, in place."""
    dist.all_reduce(visits, op=dist.ReduceOp.SUM, group=mesh.group)
    mesh.count("visits", visits.numel() * visits.element_size())
    return visits


def _all_gather_rows(mesh: Mesh, local: torch.Tensor, purpose: str) -> torch.Tensor:
    """The ranks' ``local`` blocks stacked along the leading axis in rank
    order."""
    out = torch.empty((mesh.size * local.shape[0], *local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    dist.all_gather(list(out.chunk(mesh.size)), local, group=mesh.group)
    mesh.count(purpose, out.numel() * out.element_size())
    return out


def gather_frame(mesh: Mesh, img: torch.Tensor, result: tracer.TraceResult):
    """The whole frame from each rank's row block: (image [H, W, 3],
    TraceResult of H*W rays in pixel order)."""
    cols = []
    for (_, width), field in zip(_FIELD_COLUMNS, result):
        if field.dtype == torch.bool:
            field = field.to(torch.int32)
        elif field.dtype == torch.float32:
            field = field.view(torch.int32)
        cols.append(field.reshape(-1, width))
    packed = _all_gather_rows(mesh, torch.cat(cols, dim=1), "frame_gather")
    fields, at = {}, 0
    for name, width in _FIELD_COLUMNS:
        col = packed[:, at:at + width]
        at += width
        if name in ("hit", "forced"):
            fields[name] = col[:, 0] != 0
        elif name in ("hit_pos", "normal"):
            fields[name] = col.contiguous().view(torch.float32)
        else:
            fields[name] = col[:, 0].contiguous()
    return _all_gather_rows(mesh, img.contiguous(), "frame_gather"), \
        tracer.TraceResult(**fields)


def render_frame_sharded(mesh: Mesh, words, origin, dirs, sun_dir=tracer.DEFAULT_SUN,
                         shadows=True, with_visits=False, max_steps=tracer.MAX_STEPS,
                         show_steps=False, show_hits=False, misc_bool=False,
                         u8_image=False, visit_flags=False, warp_table=None,
                         tile_size=None, mode=None, beams=None):
    """``tracer.render_frame`` with the rows of ``dirs`` (f32[H, W, 3], the
    whole frame on every rank) sharded over ``mesh`` and the pool and table
    replicated. Returns, on every rank, (image [H, W, 3], TraceResult of
    the whole frame in pixel order, visits summed over the ranks or None).

    H must divide by the mesh size. ``show_hits`` shades from the rank's own
    counts, as JAX's shard-local view does; the visits returned are the
    sum. ``mode``, ``beams`` and ``tile_size`` go to each rank's
    ``render_frame`` over its row block, as JAX's go to each shard's
    (``mode=None`` is the port's own frame): a ``beams`` tile must divide
    the block's rows (in the tiled and staged modes a tile that does not
    starts no ray below the root, as in JAX)."""
    if dirs.shape[0] % mesh.size:
        raise ValueError(f"height {dirs.shape[0]} not divisible by mesh size {mesh.size}")
    img, result, visits = tracer.render_frame(
        words, origin, shard_rows(mesh, dirs), sun_dir, shadows=shadows,
        show_steps=show_steps, misc_bool=misc_bool, max_steps=max_steps,
        warp_table=warp_table, u8_image=u8_image, with_visits=with_visits,
        show_hits=show_hits, visit_flags=visit_flags, tile_size=tile_size, mode=mode,
        beams=beams)
    if visits is not None:
        all_reduce_visits(mesh, visits)
    img, result = gather_frame(mesh, img, result)
    return img, result, visits
