"""Procedural chunk generation on the card (the port of the JAX package's
``gen/procedural.py``).

The island SDF is evaluated over the chunk's S^3 cell grid (S = 2^chunk_depth)
and one extra y-plane: a cell inside the SDF is stone, or grass where the
cell above is outside. On a CUDA device that grid comes out of kernel K7
(``csrc/block_grid.cu``) already 2-bit-packed, 16 cells a word; on the CPU
out of the plain PyTorch version, evaluated in x-slabs to bound memory as
``procedural.py:60-78`` does. The host then builds the chunk's octree with
the native dense builder (``native.build_dense``), or without the native
library with ``io.vox.build_octree_leaves``, the same breadth-first morton
layout in NumPy.

``Procedural.dispatch_chunk`` enqueues K7 and a non-blocking copy of its
words into pinned host memory with a CUDA event; ``finish_chunk`` waits on
that event and builds the tree, so ``World.generate_world`` overlaps the
next chunk's SDF with this chunk's host build. With ``structures=True`` it
then stamps trees and crystals on the chunk's grass cells
(``gen/structures.py``), which it reads from the packed words already in
host memory, seeded by ``settings.seed ^ crc32(chunk position)`` as the JAX
``Procedural._stamp`` seeds them.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels, native
from ..core.cpu_octree import CpuOctree
from ..core.voxel import CHUNK_OFFSET
from ..io.vox import build_octree_leaves
from ..state import narrow_u32
from .sdf import BASE_SCALE, SPIKE_SCALE, island_sdf

BLOCK_STONE = 1
BLOCK_GRASS = 3
# The plain version evaluates the grid in this many x-slabs to bound memory.
X_SLABS = 32

# f32 operations of one island_sdf evaluation as the algorithm states it
# (adds, subtracts, multiplies, divides, square roots, floors, floor-mods,
# min/max, abs, compares and selects, each one operation;
# csrc/block_grid.cu counts them function by function): simplex_noise3 372
# (x4), sdf_box 19, sdf_cone 38, smin 13, smoothstep 8 (x2), the island's own
# 38. Kept as the measure that compares across K7's designs.
SDF_OPS = 4 * 372 + 19 + 38 + 13 + 2 * 8 + 38
# The f32 operations the grid needs, which K7's bound counts (``k7_ops``). A
# simplex corner's three permutations and gradient (23 + 39 operations) are a
# pure function of an integer in [0, 577], so a table of 578 entries at 6 +
# 39 operations each replaces them; of the 620 operations a point that
# remain, 37 read only x and z (the island's own 17, sdf_box's 8, sdf_cone's
# 12), so a column of the grid needs them once.
K7_TABLE_OPS = 578 * (6 + 39)
K7_COLUMN_OPS = 17 + 8 + 12
K7_POINT_OPS = SDF_OPS - 4 * 4 * (23 + 39) - K7_COLUMN_OPS

# K7 computes the noise's floor-mod by 289 in int32, exact on integer-valued
# floats below this magnitude (csrc/block_grid.cu).
K7_EXACT_LIMIT = float(1 << 31)
# The largest value of the permutation polynomial (34x + 1)x the noise takes
# mod 289: x is at most 288 + 288 + 1.
PERMUTE_MAX = (34 * 577 + 1) * 577
# The largest factor that scales a coordinate into the noise, in f32 as
# island_sdf applies it: twice the largest of BASE_SCALE and SPIKE_SCALE.
_NOISE_SCALE_MAX = float(max(np.float32(BASE_SCALE * 2.0),
                             np.float32(SPIKE_SCALE).max() * np.float32(2.0)))


@dataclass
class GenSettings:
    """Generator knobs; the island SDF reads none of them (as in the JAX
    package), kept for API parity."""

    seed: int = 0
    scale: float = 0.2
    height: float = 0.2


def _grid_scale(chunk_depth: int, base_depth: int) -> float:
    """Cell size of the chunk grid, ``f32(2 / 2^(base + chunk depth))``."""
    return float(np.float32(2.0 / (1 << (base_depth + chunk_depth))))


def _pos_array(pos) -> np.ndarray:
    pos = np.asarray(pos, dtype=np.float32).reshape(-1)
    if pos.shape != (3,):
        raise ValueError(f"pos must hold 3 numbers, got {pos.shape[0]}")
    return pos


def block_grid_plain(pos, chunk_depth: int, base_depth: int, device="cpu") -> torch.Tensor:
    """Plain PyTorch version: u8[S, S, S] block ids (0 empty) of the chunk
    whose (-1, -1, -1) corner sits at world ``pos`` (3 numbers), on
    ``device``. Coordinates are ``f32(i) * scale + pos``, as
    ``procedural.py:57-63``."""
    s = 1 << chunk_depth
    x_slabs = min(X_SLABS, s)
    scale = _grid_scale(chunk_depth, base_depth)
    dev, f32 = torch.device(device), torch.float32
    p = torch.from_numpy(_pos_array(pos).copy()).to(dev)
    ys = torch.arange(s + 1, dtype=f32, device=dev) * scale + p[1]
    zs = torch.arange(s, dtype=f32, device=dev) * scale + p[2]
    n = s // x_slabs
    out = torch.empty((s, s, s), dtype=torch.uint8, device=dev)
    for x0 in range(0, s, n):
        xs = (float(x0) + torch.arange(n, dtype=f32, device=dev)) * scale + p[0]
        grid = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"), dim=-1)
        v = island_sdf(grid)
        inside = v[:, :s, :] < 0.0
        above_out = v[:, 1:, :] > 0.0
        out[x0:x0 + n] = torch.where(
            inside, torch.where(above_out, BLOCK_GRASS, BLOCK_STONE), 0).to(torch.uint8)
    return out


def pack_grid(grid: torch.Tensor) -> torch.Tensor:
    """u8 block ids -> int32 words of u32 bits, 16 cells a word over the
    flat C-order grid, cell ``16i + k`` in bits ``[2k, 2k + 1]``."""
    flat = grid.reshape(-1, 16).to(torch.int64)
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=grid.device)
    return narrow_u32((flat << shifts).sum(dim=1))


def unpack_grid(packed: torch.Tensor, chunk_depth: int) -> torch.Tensor:
    """Inverse of :func:`pack_grid`: u8[S, S, S]."""
    s = 1 << chunk_depth
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=packed.device)
    cells = (packed.to(torch.int64)[:, None] >> shifts) & 3
    return cells.reshape(-1)[: s ** 3].to(torch.uint8).reshape(s, s, s)


def block_grid_packed_plain(pos, chunk_depth: int, base_depth: int,
                            device="cpu") -> torch.Tensor:
    """Plain PyTorch version of kernel K7 (see ``block_grid_packed``)."""
    return pack_grid(block_grid_plain(pos, chunk_depth, base_depth, device))


def k7_ops(chunk_depth: int) -> int:
    """The f32 operations of one chunk's grid at ``chunk_depth`` (S^2 (S +
    1) points, S^2 columns, one table), the count K7's bound divides by the
    card's rate."""
    s = 1 << chunk_depth
    return s * s * (s + 1) * K7_POINT_OPS + s * s * K7_COLUMN_OPS + K7_TABLE_OPS


def k7_exact_range(pos, chunk_depth: int, base_depth: int) -> float:
    """An upper bound on ``|x|`` over every ``x % 289`` that the island SDF
    takes over the chunk at ``pos`` (its grid and the extra y-plane); every
    such x is an integer-valued float. They are the permutation polynomial's
    values, at most ``PERMUTE_MAX``, and the simplex lattice corners
    ``floor(v + s)``, where v is a coordinate times at most
    ``_NOISE_SCALE_MAX`` (4.6) and s a third of three such, so
    ``|floor(v + s)| <= 2 * 4.6 * |coordinate| + 1``; the bound adds 1e-5 of
    relative slack for f32 rounding. Infinite for a ``pos`` that is not
    finite."""
    p = _pos_array(pos).astype(np.float64)
    if not np.isfinite(p).all():
        return float("inf")
    reach = float(np.abs(p).max()) + ((1 << chunk_depth) + 1) * _grid_scale(chunk_depth,
                                                                            base_depth)
    return max(float(PERMUTE_MAX), 2.0 * _NOISE_SCALE_MAX * reach * (1.0 + 1e-5) + 1.0)


def _launch_block_grid(pos, chunk_depth: int, base_depth: int,
                       device: torch.device) -> torch.Tensor:
    """K7 on a CUDA ``device``: ceil(S^3 / 16) packed words. Raises, before
    any launch, for a chunk whose floor-mod inputs could reach
    ``K7_EXACT_LIMIT`` (``k7_exact_range``)."""
    if not 0 <= chunk_depth <= 10:
        raise ValueError(f"chunk_depth must be in [0, 10], got {chunk_depth}")
    reach = k7_exact_range(pos, chunk_depth, base_depth)
    if not reach < K7_EXACT_LIMIT:
        raise ValueError(f"the chunk at {pos} takes x % 289 of |x| up to {reach:.4g}, "
                         f"past K7's exact range {K7_EXACT_LIMIT:.4g}")
    p = _pos_array(pos)
    out = torch.empty(-(-(1 << (3 * chunk_depth)) // 16), dtype=torch.int32,
                      device=device)
    kernels.launch("block_grid", "ot_block_grid", device, float(p[0]), float(p[1]),
                   float(p[2]), _grid_scale(chunk_depth, base_depth), chunk_depth,
                   kernels.ptr(out))
    return out


def block_grid_packed(pos, chunk_depth: int, base_depth: int,
                      device="cuda") -> torch.Tensor:
    """The block ids of the chunk whose (-1, -1, -1) corner sits at world
    ``pos`` (3 numbers), 2-bit-packed: int32 words of u32 bits, ``S^3 / 16``
    of them (``chunk_depth >= 2``), cell ``16i + k`` of the flat C-order
    grid in bits ``[2k, 2k + 1]``, the native builder's layout. On a CUDA
    ``device`` this launches kernel K7; on the CPU it is
    ``block_grid_packed_plain``."""
    device = torch.device(device)
    if chunk_depth < 2:
        raise ValueError("a packed grid needs chunk_depth >= 2 (16 cells a word)")
    if not kernels.uses_kernel(device):
        return block_grid_packed_plain(pos, chunk_depth, base_depth, device)
    return _launch_block_grid(pos, chunk_depth, base_depth, device)


def block_grid(pos, chunk_depth: int, base_depth: int, device="cuda") -> torch.Tensor:
    """u8[S, S, S] block ids of the chunk at ``pos``: on a CUDA ``device``
    K7's words unpacked, on the CPU ``block_grid_plain``."""
    device = torch.device(device)
    if not kernels.uses_kernel(device):
        return block_grid_plain(pos, chunk_depth, base_depth, device)
    return unpack_grid(_launch_block_grid(pos, chunk_depth, base_depth, device),
                       chunk_depth)


class Procedural:
    """Chunk generator. ``device`` defaults to the card; ``"cpu"`` runs the
    plain versions. ``structures`` stamps props after the terrain (a
    crystal on the chunk-centre grass column, trees on
    ``tree_probability`` of the other grass cells). ``timings`` keeps, per
    finished chunk, the seconds spent waiting for the grid (K7 and its
    readback, past what overlapped), building the tree and stamping, the
    blocks stamped and the node count. ``asset_root`` (the port's) holds the
    ``structures/`` the stamps load."""

    def __init__(self, chunk_depth: int = 9, settings: GenSettings | None = None,
                 structures: bool = False, tree_probability: float = 0.01,
                 device="cuda", asset_root: str | None = None):
        self.chunk_depth = chunk_depth
        self.settings = settings or GenSettings()
        self.structures = structures
        self.tree_probability = tree_probability
        self.asset_root = asset_root
        self.device = kernels.resolve_device(device)
        self.timings: list[dict] = []

    def dispatch_chunk(self, pos, base_depth: int):
        """Enqueue the chunk's grid and return an opaque handle for
        ``finish_chunk``; on the card the words are on their way into pinned
        host memory when this returns."""
        if self.chunk_depth >= 2 and native.available():
            words = block_grid_packed(pos, self.chunk_depth, base_depth, self.device)
            kind = "packed"
        else:
            words = block_grid(pos, self.chunk_depth, base_depth, self.device)
            kind = "grid"
        ready = None
        if words.is_cuda:
            host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
            host.copy_(words, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            words = host
        return kind, words, ready, _pos_array(pos)

    def finish_chunk(self, handle) -> CpuOctree | None:
        """Wait for a ``dispatch_chunk`` handle, build the chunk's tree and
        stamp its structures; None for an empty chunk."""
        kind, words, ready, pos = handle
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        t1 = time.perf_counter()
        data = words.numpy()
        if kind == "packed":
            chunk = None
            if data.any():
                ptrs, vals = native.build_dense(data, self.chunk_depth)
                chunk = CpuOctree.from_arrays(ptrs, vals, copy=False)
        else:
            chunk = self._grid_to_tree(data)
        t2 = time.perf_counter()
        stamped = 0
        if chunk is not None and self.structures:
            from .structures import grass_cells_from_packed

            if kind == "packed":
                grass = grass_cells_from_packed(data, self.chunk_depth)
            else:
                grass = np.argwhere(data == BLOCK_GRASS).astype(np.int32)
            stamped = self._stamp(chunk, grass, pos)
        self.timings.append({"wait_s": t1 - t0, "build_s": t2 - t1,
                             "stamp_s": time.perf_counter() - t2, "stamped": stamped,
                             "nodes": 0 if chunk is None else len(chunk)})
        return chunk

    def _stamp(self, chunk: CpuOctree, grass_cells: np.ndarray, pos) -> int:
        """Place structures on the chunk's grass cells, deterministically per
        (settings.seed, chunk position): the seed is ``settings.seed`` xor
        the crc32 of the position's f32 bytes, stable across Python builds.
        Returns the blocks stamped."""
        from .structures import place_structures

        seed = int(self.settings.seed) ^ zlib.crc32(np.asarray(pos, np.float32).tobytes())
        return place_structures(chunk, grass_cells, self.chunk_depth, seed=seed,
                                probability=self.tree_probability,
                                asset_root=self.asset_root)

    def generate_chunk(self, pos, base_depth: int) -> CpuOctree | None:
        """The chunk whose cell corner sits at world ``pos`` with cell size
        2/2^base_depth; None for an empty chunk."""
        return self.finish_chunk(self.dispatch_chunk(pos, base_depth))

    def _grid_to_tree(self, grid: np.ndarray) -> CpuOctree | None:
        occ = np.nonzero(grid)
        if occ[0].size == 0:
            return None
        cells = np.stack(occ, axis=1).astype(np.uint32)
        blocks = grid[occ].astype(np.uint32)
        return build_octree_leaves(cells, CHUNK_OFFSET + blocks,
                                   np.zeros(blocks.shape[0], dtype=np.uint32),
                                   self.chunk_depth)
