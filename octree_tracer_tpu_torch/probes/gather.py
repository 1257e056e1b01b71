"""Row gathers and scalar adds: the probes' Pallas kernels on the card.

- ``gather_rows`` (K8, ``csrc/gather_rows.cu``) / ``gather_rows_plain``:
  ``out[i * rows + r, :] = table[starts[i] + r, :]``, the row gathers and row
  copies of ``probes/gather_probe.py`` and ``probes/pallas_min_probe.py``;
- ``add_scalar`` (K9, ``csrc/add_scalar.cu``) / ``add_scalar_plain``:
  ``x + c``, their elementwise kernels.

Tables and words are u32 carried as int32 tensors of the same bits. Starts
are checked on the host before they are uploaded: pass a NumPy array, or a
:class:`Starts` from :func:`upload_starts` to upload once and launch many
times. A wrapper runs its plain version only for tensors on the CPU; on a
CUDA device it launches its kernel or raises.

Each kernel's launch (which of its kernels, vectors or words, 32- or 64-bit
offsets, grid) is decided on the host by a pure function of shapes and
addresses, :func:`gather_plan` and :func:`add_plan`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

_I32 = torch.int32
SMS = 132  # streaming multiprocessors of the H100 SXM
L2_BYTES = 50 << 20  # the H100's L2 cache
_LIMIT_32 = (1 << 31) - (1 << 16)  # offsets below this (and a tile past it) fit 32 bits
BLOCK = 256  # threads a block of K8 and K9 (csrc kBlock)
TILE_VECS = 2  # 16-byte vectors a lane of K8's tile kernel keeps in flight (csrc kU)


class Starts(NamedTuple):
    """Row starts on a device, with the range the host checked."""

    tensor: torch.Tensor  # int32[n]
    lo: int
    hi: int


def upload_starts(starts, device) -> Starts:
    """Check integer ``starts`` on the host and upload them as int32."""
    a = np.asarray(starts)
    if a.dtype.kind not in "iu":
        raise TypeError(f"starts must be integers, got {a.dtype}")
    a = a.reshape(-1).astype(np.int64)
    lo, hi = (int(a.min()), int(a.max())) if a.size else (0, -1)
    if lo < 0 or hi >= 1 << 31:
        raise ValueError(f"starts must lie in [0, 2^31), got [{lo}, {hi}]")
    return Starts(torch.from_numpy(a.astype(np.int32)).to(device), lo, hi)


class GatherPlan(NamedTuple):
    """K8's launch. A unit is a 16-byte vector (``vector``) or a word; start
    i copies one segment of ``seg`` units (``rows`` table rows of
    ``row_units``)."""

    design: str  # "flat" or "tile"
    vector: bool
    row_units: int
    seg: int
    log_seg: int  # log2(seg), -1 if seg is no power of two
    blocks: int  # of BLOCK threads
    wide: bool  # 64-bit offsets


def gather_plan(g: int, w: int, n_starts: int, rows: int, table_addr: int,
                out_addr: int) -> GatherPlan:
    """K8's launch for ``n_starts`` starts of ``rows`` rows of a ``[g, w]``
    u32 table at byte address ``table_addr`` into an output at
    ``out_addr``. 16-byte vectors when ``w`` is a multiple of 4 and both
    addresses are 16-byte aligned, else words. The tile kernel (a warp's 64
    output vectors, two a lane in flight) for vectors and a power-of-two
    segment of two vectors or more, when one unit a thread would take more
    than one wave of the card and the table is more than a sixteenth of the
    L2; else the flat kernel (one unit a thread, the segment by a shift or,
    for a segment of no power-of-two length, one division)."""
    vector = w % 4 == 0 and table_addr % 16 == 0 and out_addr % 16 == 0
    row_units = w // 4 if vector else w
    seg = rows * row_units
    log_seg = seg.bit_length() - 1 if seg > 0 and seg & (seg - 1) == 0 else -1
    total = n_starts * seg
    wide = max(g * row_units, total) >= _LIMIT_32
    large = total > SMS * 2048 and g * w * 4 > L2_BYTES // 16
    if vector and log_seg >= 1 and large:
        return GatherPlan("tile", vector, row_units, seg, log_seg,
                          -(-total // (32 * TILE_VECS * (BLOCK // 32))), wide)
    return GatherPlan("flat", vector, row_units, seg, log_seg, -(-total // BLOCK), wide)


def _row_index(starts: torch.Tensor, rows: int) -> torch.Tensor:
    offs = torch.arange(rows, dtype=torch.int64, device=starts.device)
    return (starts.to(torch.int64)[:, None] + offs).reshape(-1)


def gather_rows_plain(table: torch.Tensor, starts: torch.Tensor, rows: int = 1):
    """Plain PyTorch version of kernel K8 (see ``gather_rows``)."""
    return table[_row_index(starts, rows)]


def gather_rows(table: torch.Tensor, starts, rows: int = 1) -> torch.Tensor:
    """``out[i * rows + r, :] = table[starts[i] + r, :]`` for an int32
    ``[G, w]`` table: int32 ``[len(starts) * rows, w]``. ``starts`` is a
    NumPy integer array or a :class:`Starts`; each must lie in
    ``[0, G - rows]``. On a CUDA device this launches kernel K8 as
    :func:`gather_plan` plans it; on the CPU it is ``gather_rows_plain``."""
    dev = table.device
    kernels.check(table, "table", _I32, (None, None), dev)
    if not isinstance(starts, Starts):
        starts = upload_starts(starts, dev)
    kernels.check(starts.tensor, "starts", _I32, (None,), dev)
    g, w = table.shape
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    if starts.lo < 0 or starts.hi + rows > g:
        raise ValueError(f"starts [{starts.lo}, {starts.hi}] + {rows} rows leave the "
                         f"{g}-row table")
    if not kernels.uses_kernel(dev):
        return gather_rows_plain(table, starts.tensor, rows)
    n = starts.tensor.shape[0]
    out = torch.empty((n * rows, w), dtype=_I32, device=dev)
    p = gather_plan(g, w, n, rows, table.data_ptr(), out.data_ptr())
    kernels.launch("gather_rows", "ot_gather_rows", dev, kernels.ptr(table),
                   kernels.ptr(starts.tensor), n, kernels.ptr(out), int(p.design == "tile"),
                   int(p.vector), p.row_units, p.seg, p.log_seg, p.blocks, int(p.wide))
    return out


def gather_bytes(starts, rows: int, w: int) -> int:
    """The bytes K8 must move for one start set: each distinct table row the
    starts reach read once, each output row written once, 4 bytes a start."""
    s = np.asarray(starts, np.int64).reshape(-1)
    distinct = np.unique((s[:, None] + np.arange(rows)).reshape(-1)).size
    return (distinct + s.size * rows) * w * 4 + 4 * s.size


class AddPlan(NamedTuple):
    """K9's launch: ``head`` elements, ``n_vec`` 16-byte vectors, one a
    thread, and ``tail`` elements."""

    head: int
    n_vec: int
    tail: int
    blocks: int  # of BLOCK threads
    wide: bool  # 64-bit offsets


def add_plan(n: int, addr: int) -> AddPlan:
    """K9's launch for ``n`` 4-byte elements at byte address ``addr`` (x's;
    the wrapper gives out the same address modulo 16). The head runs to the
    first 16-byte boundary, the tail is what is left after the last whole
    vector. A 4-byte tensor always lies on a 4-byte boundary; any other
    address raises."""
    if addr % 4:
        raise ValueError(f"address {addr:#x} is not 4-byte aligned")
    head = min(-addr % 16 // 4, n)
    n_vec = (n - head) // 4
    tail = n - head - 4 * n_vec
    blocks = max(-(-n_vec // BLOCK), 1 if n else 0)
    return AddPlan(head, n_vec, tail, blocks, n >= _LIMIT_32)


def _u32_bits(c: int) -> int:
    c = int(c)
    if not -(1 << 31) <= c < 1 << 32:
        raise ValueError(f"scalar {c} does not fit 32 bits")
    return c & 0xFFFFFFFF


def add_scalar_plain(x: torch.Tensor, c) -> torch.Tensor:
    """Plain PyTorch version of kernel K9 (see ``add_scalar``)."""
    if isinstance(c, torch.Tensor):
        return x + c.reshape(())
    if x.dtype == _I32:
        b = _u32_bits(c)
        return x + (b - (1 << 32) if b >= 1 << 31 else b)
    return x + float(c)


def _empty_like_aligned_as(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor like contiguous ``x`` whose address is x's modulo 16,
    so that both meet 16-byte boundaries at the same element."""
    phase = x.data_ptr() % 16
    if phase == 0:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + 3, dtype=x.dtype, device=x.device)
    e = (phase - buf.data_ptr() % 16) % 16 // 4
    return buf[e:e + x.numel()].view(x.shape)


def add_scalar(x: torch.Tensor, c) -> torch.Tensor:
    """``x + c`` for an f32 tensor, or an int32 tensor of u32 bits (modulo
    2^32), any contiguous view. ``c`` is a Python number, or a one-element
    tensor of x's type on x's device (the probes' scalar-prefetch operand),
    read by the kernel. On a CUDA device this launches kernel K9 as
    :func:`add_plan` plans it; on the CPU it is ``add_scalar_plain``."""
    dev = x.device
    if x.dtype not in (torch.float32, _I32):
        raise TypeError(f"x must be float32 or int32, got {x.dtype}")
    kernels.check(x, "x", x.dtype, None, dev)
    if isinstance(c, torch.Tensor):
        kernels.check(c, "c", x.dtype, None, dev)
        if c.numel() != 1:
            raise ValueError(f"c must hold one element, got {c.numel()}")
    if not kernels.uses_kernel(dev):
        return add_scalar_plain(x, c)
    out = _empty_like_aligned_as(x)
    p = add_plan(x.numel(), x.data_ptr())
    c_ptr = kernels.ptr(c) if isinstance(c, torch.Tensor) else None
    if x.dtype == torch.float32:
        entry, value = "ot_add_scalar_f32", 0.0 if c_ptr else float(c)
    else:
        entry, value = "ot_add_scalar_u32", 0 if c_ptr else _u32_bits(c)
    kernels.launch("add_scalar", entry, dev, kernels.ptr(x), kernels.ptr(out), p.head,
                   p.n_vec, p.tail, p.blocks, int(p.wide), value, c_ptr)
    return out
