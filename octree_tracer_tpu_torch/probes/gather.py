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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

_I32 = torch.int32


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
    ``[0, G - rows]``. On a CUDA device this launches kernel K8; on the CPU
    it is ``gather_rows_plain``."""
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
    kernels.launch("gather_rows", "ot_gather_rows", dev, kernels.ptr(table), w,
                   kernels.ptr(starts.tensor), n, rows, kernels.ptr(out))
    return out


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


def add_scalar(x: torch.Tensor, c) -> torch.Tensor:
    """``x + c`` for an f32 tensor, or an int32 tensor of u32 bits (modulo
    2^32). ``c`` is a Python number, or a one-element tensor of x's type on
    x's device (the probes' scalar-prefetch operand), read by the kernel.
    On a CUDA device this launches kernel K9; on the CPU it is
    ``add_scalar_plain``."""
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
    out = torch.empty_like(x)
    c_ptr = kernels.ptr(c) if isinstance(c, torch.Tensor) else None
    if x.dtype == torch.float32:
        kernels.launch("add_scalar", "ot_add_scalar_f32", dev, kernels.ptr(x),
                       kernels.ptr(out), x.numel(), 0.0 if c_ptr else float(c), c_ptr)
    else:
        kernels.launch("add_scalar", "ot_add_scalar_u32", dev, kernels.ptr(x),
                       kernels.ptr(out), x.numel(), 0 if c_ptr else _u32_bits(c), c_ptr)
    return out
