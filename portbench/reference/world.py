"""The world a Session streams from, as the reference sees it, and the walk
that holds a Session's pool to it.

The world is one tree joined across its chunks: a chunk reference leads to
the referenced chunk's root group. Each interior's colour is worked out
again from the leaves by the upstream mip rule (ria8651/octree-tracer
``src/world.rs``): per channel, the mean of the non-empty children,
truncated to a byte and at least 1. A chunk reference's colour is its
chunk's root group's mean by the same rule.

A Session's pool node at a path from the root is what the adaptive engine
builds from the world at that path: an interior only where the world's node
has children, and then over the world's children; a leaf of the world
node's colour (a leaf's own, an interior's mip)."""

from __future__ import annotations

import os

import numpy as np
import torch

from . import chunks
from .trace import VOXEL_OFFSET

MAX_DEPTH = 24
_EIGHT = np.arange(8, dtype=np.int64)


def from_words(words: np.ndarray, device) -> dict:
    """The tree of one chunk given as pool words (u32): ``child`` (int64,
    the slot of a node's child group, -1 for a leaf) and ``colour``
    (int64, RGB888: a leaf's colour, an interior's mip)."""
    payload = torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64) >> 4).to(device)
    leaf = payload >= VOXEL_OFFSET
    child = torch.where(leaf, torch.full_like(payload, -1), payload)
    colour = torch.where(leaf, payload - VOXEL_OFFSET, torch.zeros_like(payload))
    return with_mips({"child": child, "colour": colour})


def from_chunk_files(path: str, device) -> dict:
    """The tree of a world saved as chunk files (``<path>/<id>.bin``, the
    root chunk 0): every chunk that a chunk read references, where its file
    is there, read in turn and laid out after the ones before it. A
    reference to a chunk with no file (a block of a library the world does
    not hold) is a leaf of the colour its record stores."""
    ptrs, colours, offset = [], [], {}
    todo, total = [0], 0
    while todo:
        cid = todo.pop(0)
        if cid in offset:
            continue
        rec = chunks.read(os.path.join(path, f"{cid}.bin"))
        offset[cid] = total
        total += rec.shape[0]
        ptr = torch.from_numpy(rec["pointer"].astype(np.int64)).to(device)
        ptrs.append(ptr)
        colours.append(torch.from_numpy((rec["r"].astype(np.int64) << 16)
                                        | (rec["g"].astype(np.int64) << 8)
                                        | rec["b"].astype(np.int64)).to(device))
        refs = torch.unique(ptr[ptr > chunks.CHUNK_OFFSET] - chunks.CHUNK_OFFSET).tolist()
        todo += [r for r in refs if os.path.exists(os.path.join(path, f"{r}.bin"))]
    known = torch.tensor(sorted(offset), dtype=torch.int64, device=device)
    starts = torch.tensor([offset[k] for k in sorted(offset)], dtype=torch.int64, device=device)
    child = []
    for cid, ptr in zip(offset, ptrs):
        c = torch.where(ptr < chunks.CHUNK_OFFSET, ptr + offset[cid], -1)
        ref = ptr > chunks.CHUNK_OFFSET
        ids = ptr[ref] - chunks.CHUNK_OFFSET
        at = torch.searchsorted(known, ids).clamp_max(known.numel() - 1)
        c[ref] = torch.where(known[at] == ids, starts[at], -1)
        child.append(c)
    child = torch.cat(child)
    colour = torch.where(child < 0, torch.cat(colours), 0)
    return with_mips({"child": child, "colour": colour})


def with_mips(tree: dict) -> dict:
    """``tree`` with every interior's colour set to its mip, bottom up over
    the levels below the root group (slots 0-7)."""
    child, colour = tree["child"], tree["colour"]
    eight = torch.from_numpy(_EIGHT).to(child.device)
    levels = []
    frontier = torch.nonzero(child[:8] >= 0).squeeze(1)
    while frontier.numel():
        if len(levels) == MAX_DEPTH:
            raise ValueError("the world is deeper than the walk's depth cap")
        levels.append(frontier)
        kids = (child[frontier][:, None] + eight).reshape(-1)
        frontier = kids[child[kids] >= 0]
    for level in reversed(levels):
        cv = colour[child[level][:, None] + eight]
        filled = cv != 0
        count = filled.sum(dim=1)
        out = torch.zeros_like(level)
        for shift in (16, 8, 0):
            mean = ((cv >> shift) & 0xFF).sum(dim=1) // count.clamp_min(1)
            out |= mean.clamp_min(1) << shift
        colour[level] = out
    return tree


def pool_off(pool: torch.Tensor, tree: dict) -> dict:
    """Walk the pool (int64 u32 words) from its root group beside the
    world's tree: ``nodes`` reachable, and ``off``, those that are not what
    the engine builds from the world at their path (an interior where the
    world has a leaf, a leaf of another colour, a child group out of the
    pool, or nodes deeper than the depth cap)."""
    dev = pool.device
    eight = torch.arange(8, device=dev)
    group_p = torch.zeros(1, dtype=torch.int64, device=dev)
    group_w = torch.zeros(1, dtype=torch.int64, device=dev)
    nodes = off = 0
    for _ in range(MAX_DEPTH):
        inside = group_p + 8 <= pool.shape[0]
        off += 8 * int((~inside).sum())
        group_p, group_w = group_p[inside], group_w[inside]
        if not group_p.numel():
            break
        ps = (group_p[:, None] + eight).reshape(-1)
        ws = (group_w[:, None] + eight).reshape(-1)
        payload = pool[ps] >> 4
        leaf = payload >= VOXEL_OFFSET
        world_child = tree["child"][ws]
        wrong = torch.where(leaf, payload - VOXEL_OFFSET != tree["colour"][ws], world_child < 0)
        nodes += ps.numel()
        off += int(wrong.sum())
        down = ~leaf & (world_child >= 0)
        group_p, group_w = payload[down], world_child[down]
    else:
        off += 8 * group_p.numel()
    return {"nodes": nodes, "off": off}
