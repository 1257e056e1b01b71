"""Octant-directional free-space skip fields (the JAX package's
``render/skip.py``).

Per cell of the 2^L grid and per ray-sign octant, the side B of the largest
empty cube anchored at the cell and extending in the octant's direction, as
a 4-bit codebook nibble (0..12, 16, 24, 32); eight nibbles make one u32 per
cell. The combined table interleaves each cell's warp word (at 2c) with its
skip word (at 2c+1), so the traversal fetches both in one 32-byte row.

The occupancy comes from kernel K2 (``tracer.warp_occupancy``) and the skip
words from kernel K12 (``csrc/skip_field.cu``), both on the card, where JAX
composes the cubes in host NumPy (``skip.py:141-147``);
``build_skip_field_plain`` is that NumPy build, the plain version on the
CPU. ``decode_skip`` is the codebook that the traversal's plain version
reads (``tracer._decode_skip``) and kernel K1 mirrors (``csrc/trace.cu``
``decode_skip``). This module takes ``tracer`` at call time, because
``tracer`` imports the codebook from here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

SKIP_CAP = 32  # largest encodable cube side (codebook 0..12, 16, 24, 32)


def decode_skip(v: torch.Tensor) -> torch.Tensor:
    """Codebook nibble -> cube side in cells: 0..12 as they are, 13/14/15
    -> 16/24/32."""
    return torch.where(v <= 12, v, (v - 11) * 8)


def encode_skip(b: torch.Tensor) -> torch.Tensor:
    """Cube side -> codebook nibble, floored (conservative): the largest
    codebook value not above ``b``, as int32."""
    b = torch.clamp(b, max=SKIP_CAP)
    nib = torch.where(b <= 12, b, torch.where(b < 16, 12, torch.where(
        b < 24, 13, torch.where(b < 32, 14, 15))))
    return nib.to(torch.int32)


def occupancy_from_pool(words: torch.Tensor, levels: int) -> torch.Tensor:
    """bool[8^levels] (flat, x-major like the warp table): the cell holds
    filled geometry (its covering node is not an empty leaf)."""
    from .tracer import warp_occupancy

    return warp_occupancy(words, levels)[1]


def k12_bytes(levels: int) -> int:
    """Bytes K12 must move for the 2^levels grid: the occupancy byte read
    and the skip word written, 5 a cell."""
    return 5 * 8 ** levels


def build_skip_field_plain(occ: torch.Tensor, levels: int) -> torch.Tensor:
    """Plain version of kernel K12: the JAX package's NumPy build on the
    host, int32[8^levels] of u32 skip words on ``occ``'s device.

    Empty-cube indicators with overlap-doubling, per octant (axes flipped so
    the octant points +,+,+): E_{j+k} is the AND of E_k at the eight offsets
    j*{0,1}^3, so 14 compositions reach every codebook side. The nibble is
    the count of true codebook indicators, the floor-quantized cube side.
    Outside the root cube counts as empty."""
    side = 1 << levels
    occ3 = occ.cpu().numpy().reshape(side, side, side)
    out = np.zeros(side ** 3, dtype=np.uint32)

    def compose(e, o):
        """E_{k+o} from E_k (k >= o): AND over offsets o*{0,1}^3."""
        p = np.pad(e, ((0, o), (0, o), (0, o)), constant_values=True)
        out2 = e.copy()
        for ox in (0, o):
            for oy in (0, o):
                for oz in (0, o):
                    if ox == oy == oz == 0:
                        continue
                    out2 &= p[ox:ox + side, oy:oy + side, oz:oz + side]
        return out2

    for oct_ in range(8):
        neg = tuple(ax for ax in range(3) if not (oct_ >> (2 - ax)) & 1)
        o3 = np.flip(occ3, axis=neg) if neg else occ3
        e = {1: ~o3}
        for k, base, off in ((2, 1, 1), (3, 2, 1), (4, 2, 2), (5, 4, 1),
                             (6, 4, 2), (7, 4, 3), (8, 4, 4), (9, 8, 1),
                             (10, 8, 2), (11, 8, 3), (12, 8, 4), (16, 8, 8),
                             (24, 16, 8), (32, 16, 16)):
            e[k] = compose(e[base], off)
        nib = np.zeros(o3.shape, dtype=np.uint32)
        for k in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 16, 24, 32):
            nib += e[k].astype(np.uint32)
        if neg:
            nib = np.flip(nib, axis=neg)
        out |= nib.reshape(-1) << np.uint32(4 * oct_)
    return torch.from_numpy(out.view(np.int32)).to(occ.device)


def build_skip_field(words: torch.Tensor, levels: int = 7,
                     occ: torch.Tensor | None = None,
                     table: torch.Tensor | None = None) -> torch.Tensor:
    """int32[8^levels] of u32 skip words (nibble of octant o = sx*4 + sy*2 +
    sz at bits [4o, 4o+4)), on ``words``' device. ``occ`` is the grid's
    occupancy (``occupancy_from_pool``), computed when None. With ``table``,
    a combined table of the same grid (int32[2 * 8^levels]), the words go
    to its odd words in place, its warp words untouched, and ``table`` is
    returned.

    On a CUDA device this launches kernel K2 (when ``occ`` is None), then
    kernel K12; on the CPU it is ``build_skip_field_plain``."""
    if not 0 <= levels <= 9:
        raise ValueError(f"levels must be in [0, 9], got {levels}")
    dev = words.device
    n = 1 << (3 * levels)
    if occ is None:
        occ = occupancy_from_pool(words, levels)
    kernels.check(occ, "occ", torch.bool, (n,), dev)
    if table is not None:
        kernels.check(table, "table", torch.int32, (2 * n,), dev)
    if not kernels.uses_kernel(dev):
        skip = build_skip_field_plain(occ, levels)
        if table is None:
            return skip
        table[1::2] = skip
        return table
    out = torch.empty(n, dtype=torch.int32, device=dev) if table is None else table
    # The skip word of cell c at out[c], or at table[2c + 1]: 4 bytes in.
    stride, offset = (1, 0) if table is None else (2, 4)
    side = 1 << levels
    # K12's occupancy bits: a word of 32 cells along z, side / 32 a column.
    bits = torch.empty(side * side * max(side // 32, 1), dtype=torch.int32, device=dev)
    kernels.launch("skip_field", "ot_skip_field", dev, kernels.ptr(occ), levels,
                   int(occ.data_ptr() % 16 == 0), kernels.ptr(bits), out.data_ptr() + offset,
                   stride)
    return out


def build_warp_skip_table(words: torch.Tensor, levels: int = 7) -> torch.Tensor:
    """Combined table int32[2 * 8^levels]: cell c's warp word at 2c and its
    skip word at 2c+1. One K2 launch gives both the warp words and the
    occupancy the skip field is built from; the warp words go in with one
    device copy, and K12 writes the skip words in place."""
    from .tracer import warp_occupancy

    warp, occ = warp_occupancy(words, levels)
    table = torch.empty(2 * warp.shape[0], dtype=torch.int32, device=words.device)
    table[0::2] = warp
    return build_skip_field(words, levels, occ=occ, table=table)
