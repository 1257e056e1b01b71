"""The reference level-of-detail decision (ria8651/octree-tracer
``src/adaptive.rs``): after a frame, a filled leaf that at least 4 rays
read (the 4-bit counter saturating at 15) is a candidate to subdivide, an
interior that no ray read is a candidate to collapse. Only slots below the
live length whose word is not 0 count."""

from __future__ import annotations

import torch

from .trace import VOXEL_OFFSET


def candidates(words: torch.Tensor, visits: torch.Tensor, node_len: int):
    """(subdivide mask, collapse mask) over the pool ``words`` (int64 u32
    values) given ``visits`` (int64, one a slot)."""
    payload = words >> 4
    slot = torch.arange(words.shape[0], device=words.device)
    valid = (words != 0) & (slot < node_len)
    counter = visits.clamp_max(15)
    sub = valid & (counter >= 4) & (payload > VOXEL_OFFSET)
    unsub = valid & (counter == 0) & (payload < VOXEL_OFFSET)
    return sub, unsub
