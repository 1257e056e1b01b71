"""Brick maps: 4x4x4 occupancy rows for an arithmetic DDA at the bottom of
the tree (the JAX package's ``render/bricks.py``).

A *brick* stands for an interior node whose subtree is at most two levels
high. Its row in the ``(pool, 8)`` brick table holds u32 words:

    w0  bit 0      valid flag (1 in every stored brick row)
        bits 1-8   coarse-leaf mask: child ``c`` is a leaf, not interior
    w1  occupancy bits  0-31  (fine cell bit = ccode * 8 + gcode)
    w2  occupancy bits 32-63
    w3  children group index (the brick root's payload)
    w4-w7  zero

A filled or empty coarse leaf is replicated into its 8 fine bits, so the
fine occupancy answers "is the actual leaf here filled" everywhere in the
brick. Validity is advertised in bit 0 of the *decorated* pool word, the
low nibble that ``word >> 4`` drops, so a descending ray switches to the
brick DDA without another read (``tracer.trace(..., bricks=...)``).

``build_bricks`` is kernel K10 (``csrc/brick_rows.cu``) on the card and
``build_bricks_plain`` on the CPU; ``build_bricks_np`` is the host NumPy
version, equal to both array for array. Words are int32 tensors holding u32
bits (``state.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core.voxel import VOXEL_OFFSET
from ..state import narrow_u32, widen_u32
from .tracer import _check_pool

BRICK_VALID = 1  # bit 0 of w0 / of the decorated node word

# Slots a pass of the plain version takes at once: its grandchild rows are
# 64 int64 a slot.
_PLAIN_CHUNK = 1 << 20


def build_bricks_np(words: np.ndarray):
    """The brick table on the host, in NumPy. Returns ``(words_dec, bricks)``: the
    decorated pool (bit 0 set on valid brick roots) and the (pool, 8) u32
    brick-row table (zeros for slots that are no brick root)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    pool = words.shape[0]
    pad = (-pool) % 8
    wp = np.pad(words, (0, pad))
    w2d = wp.reshape(-1, 8)
    voff = np.uint32(VOXEL_OFFSET)

    payload = words >> np.uint32(4)
    interior = payload < voff
    # Group pointers are 8-aligned in a well-formed pool; the clamp keeps
    # garbage and hole words inside the padded table.
    grp = np.minimum(payload, np.uint32(w2d.shape[0] * 8 - 8))
    children = w2d[grp // 8]                      # (pool, 8)
    cp = children >> np.uint32(4)
    child_leaf = cp >= voff                       # (pool, 8)
    child_filled = cp > voff
    ggrp = np.minimum(np.where(child_leaf, 0, cp), np.uint32(w2d.shape[0] * 8 - 8))
    grand = w2d[ggrp.reshape(-1) // 8].reshape(pool, 8, 8)
    gp = grand >> np.uint32(4)
    g_leaf = gp >= voff
    g_filled = gp > voff

    # word == 0 slots (free-list holes, padding) decode as interior with
    # payload 0; they are never decorated.
    valid = (
        interior
        & (words != 0)
        & np.all(child_leaf | np.all(g_leaf, axis=2), axis=1)
    )

    occ = np.where(child_leaf[:, :, None], child_filled[:, :, None], g_filled)
    shifts = np.arange(8, dtype=np.uint32)
    cbytes = (occ.astype(np.uint32) << shifts).sum(axis=2).astype(np.uint32)
    lo = (
        cbytes[:, 0]
        | (cbytes[:, 1] << np.uint32(8))
        | (cbytes[:, 2] << np.uint32(16))
        | (cbytes[:, 3] << np.uint32(24))
    )
    hi = (
        cbytes[:, 4]
        | (cbytes[:, 5] << np.uint32(8))
        | (cbytes[:, 6] << np.uint32(16))
        | (cbytes[:, 7] << np.uint32(24))
    )
    w0 = np.uint32(BRICK_VALID) | (
        (child_leaf.astype(np.uint32) << (shifts + np.uint32(1))).sum(axis=1)
    ).astype(np.uint32)

    bricks = np.zeros((pool, 8), dtype=np.uint32)
    bricks[valid, 0] = w0[valid]
    bricks[valid, 1] = lo[valid]
    bricks[valid, 2] = hi[valid]
    bricks[valid, 3] = payload[valid]

    words_dec = words | valid.astype(np.uint32)
    return words_dec, bricks


def _padded_rows(w: torch.Tensor) -> torch.Tensor:
    """Widened words padded with zeros to whole 8-word rows, as rows."""
    return torch.cat([w, w.new_zeros((-w.shape[0]) % 8)]).reshape(-1, 8)


def _descend(w2d: torch.Tensor, w: torch.Tensor):
    """For widened words ``w`` of the pool ``w2d``: (payload, the children
    (m, 8), each child's own row (m, 8, 8)), with JAX's ``min(payload,
    rows * 8 - 8)`` clamps and row 0 for a leaf child."""
    cap = w2d.shape[0] * 8 - 8
    payload = w >> 4
    children = w2d[payload.clamp(max=cap) >> 3]
    cp = children >> 4
    grow = torch.where(cp >= VOXEL_OFFSET, 0, cp).clamp(max=cap) >> 3
    return payload, children, w2d[grow]


def _brick_rows(w2d: torch.Tensor, w: torch.Tensor):
    """(decorated words, brick rows), int64, of the widened words ``w``."""
    payload, children, grand = _descend(w2d, w)
    cp = children >> 4
    child_leaf = cp >= VOXEL_OFFSET
    child_filled = cp > VOXEL_OFFSET
    gp = grand >> 4
    valid = ((payload < VOXEL_OFFSET) & (w != 0)
             & (child_leaf | (gp >= VOXEL_OFFSET).all(dim=2)).all(dim=1))
    occ = torch.where(child_leaf[:, :, None], child_filled[:, :, None], gp > VOXEL_OFFSET)
    shifts = torch.arange(8, device=w.device)
    cbytes = (occ.long() << shifts).sum(dim=2)
    lo = cbytes[:, 0] | (cbytes[:, 1] << 8) | (cbytes[:, 2] << 16) | (cbytes[:, 3] << 24)
    hi = cbytes[:, 4] | (cbytes[:, 5] << 8) | (cbytes[:, 6] << 16) | (cbytes[:, 7] << 24)
    w0 = BRICK_VALID | (child_leaf.long() << (shifts + 1)).sum(dim=1)
    z = torch.zeros_like(w)
    rows = torch.stack([w0, lo, hi, payload, z, z, z, z], dim=1) * valid[:, None]
    return w | valid.long(), rows


def build_bricks_plain(words: torch.Tensor):
    """Plain PyTorch version of kernel K10, JAX ``build_bricks``
    (bricks.py:110) as separate ops: (decorated pool int32[pool], brick
    table int32[pool, 8]), u32 bits."""
    w = widen_u32(words)
    w2d = _padded_rows(w)
    parts = [_brick_rows(w2d, w[s:s + _PLAIN_CHUNK])
             for s in range(0, w.shape[0], _PLAIN_CHUNK)]
    return (narrow_u32(torch.cat([d for d, _ in parts])),
            narrow_u32(torch.cat([r for _, r in parts])))


def k10_bytes(words: torch.Tensor) -> int:
    """Bytes K10 must move for ``words``: the pool read once (the children
    and grandchildren rows it reads are rows of the same pool) and 36 bytes
    a slot written, the decorated word and the 32-byte brick row."""
    return 40 * words.shape[0]


def build_bricks(words: torch.Tensor):
    """(decorated pool, brick table) of ``words`` (int32[pool] of u32
    bits): bit 0 set on every valid brick root, and the (pool, 8) table of
    brick rows (zeros for other slots), as JAX ``build_bricks``
    (bricks.py:110). Pass both to ``tracer.trace`` or ``render_frame``. On
    a CUDA device this launches kernel K10; on the CPU it is
    ``build_bricks_plain``."""
    dev = words.device
    kernels.check(words, "words", torch.int32, (None,))
    _check_pool(words)
    if not kernels.uses_kernel(dev):
        return build_bricks_plain(words)
    n = words.shape[0]
    dec = torch.empty_like(words)
    rows = torch.empty((n, 8), dtype=torch.int32, device=dev)
    kernels.launch("brick_rows", "ot_brick_rows", dev, kernels.ptr(words), n,
                   int(words.data_ptr() % 16 == 0), kernels.ptr(dec), kernels.ptr(rows))
    return dec, rows
