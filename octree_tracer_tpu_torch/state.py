"""The JAX package's state as the port's tensors, and the numeric rules the
plain PyTorch versions follow to stay bit-equal to the kernels.

Pool words and table words are u32, and leaf words are >= 2^31. The port
carries them as ``torch.int32`` tensors holding the same bits: the CUDA
kernels read them as ``const uint32_t*``, and the plain PyTorch path widens
them once with :func:`widen_u32`, because on the CPU ``torch.uint32`` has no
``>>`` or ``<`` and ``int32 >>`` is an arithmetic shift.

A World crosses between the packages as NumPy arrays (``world_to_numpy``,
``world_from_numpy``), so both Sessions can stream from the same chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.cpu_octree import CpuOctree
from .world.world import World


def u32_to_device(words: np.ndarray, device) -> torch.Tensor:
    """u32 array (pool words from ``CpuOctree.to_words()``, a warp table or a
    combined table) -> int32 tensor with the same bits on ``device``."""
    a = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of u32 bits -> u32 numpy array."""
    return t.detach().cpu().numpy().view(np.uint32)


def widen_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & 0xFFFFFFFF


def narrow_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def div_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as IEEE f32 division on any device. PyTorch's CUDA division
    by a CPU scalar multiplies by the scalar's rounded reciprocal instead,
    which is not bit-equal; a divisor tensor on x's device divides."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def world_to_numpy(world) -> dict:
    """A World's chunks, of either package, as ``{id: (pointers, values,
    top_mip)}`` NumPy copies."""
    return {int(cid): (c.pointers.copy(), c.values.copy(), int(c.top_mip))
            for cid, c in world.chunks.items()}


def world_from_numpy(chunks: dict):
    """The port's World (no block library) holding ``world_to_numpy``'s
    chunks."""
    world = World(load_blocks=False)
    for cid, (ptrs, vals, top_mip) in chunks.items():
        world.chunks[cid] = CpuOctree.from_arrays(ptrs, vals, top_mip=top_mip)
    return world


def table_to_device(table: np.ndarray, device) -> torch.Tensor:
    """A warp table u32[8^L] or combined warp+skip table u32[2*8^L] on
    ``device``; raises on any other length."""
    from .render.tracer import warp_table_levels

    warp_table_levels(table)
    return u32_to_device(table, device)
