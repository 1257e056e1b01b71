"""``.vox`` exporter — write a CpuOctree back out as a MagicaVoxel model
(the JAX package's ``io/vox_export.py``, copied).

The reference only *reads* .vox (src/cpu_octree.rs:177-210); exporting closes
the interchange loop: generated chunks and streamed worlds can be opened in
MagicaVoxel (or re-imported by the reference itself). The coordinate remap
inverts the loader's: octree cell (x, y, z) -> vox (size-1-x, z, y)
(``io/vox.py voxels_to_cells``), so ``load_vox(save_vox(t))`` reproduces the
same cells. Palette indexing follows the dot_vox direct convention both
loaders use (see the palette note in ``save_vox`` for the one-slot
difference vs MagicaVoxel's display).

MagicaVoxel limits: cubic models up to 256 per side (export depth <= 8) and a
255-colour palette; trees with more unique leaf colours are quantized to the
255 most frequent (others map to the nearest by RGB distance).
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.cpu_octree import CpuOctree
from ..core.voxel import CHUNK_OFFSET


def tree_to_cells(tree: CpuOctree, depth: int):
    """Collect the filled cells of ``tree`` at resolution ``2^depth``:
    (cells uint32[N,3], rgb24 uint32[N]).

    Filled leaves above ``depth`` expand to all covered cells; leaves below
    are truncated away (their ancestors at ``depth`` carry the mip colour —
    same information the renderer's LOD shows at that depth). Block
    references export their mip colour (the node ``value``, like the
    reference's mip rendering of unexpanded chunks)."""
    ptr = tree.pointers
    val = tree.values
    side = 1 << depth

    cells: list[np.ndarray] = []
    rgbs: list[np.ndarray] = []
    # Frontier of (node index, cell x, y, z at current level, level).
    idx = np.arange(8, dtype=np.int64)
    cx = (idx >> 2) & 1
    cy = (idx >> 1) & 1
    cz = idx & 1
    frontier = (idx, cx.astype(np.int64), cy.astype(np.int64),
                cz.astype(np.int64))
    for level in range(1, depth + 1):
        idx, cx, cy, cz = frontier
        if idx.size == 0:
            break
        p = ptr[idx]
        v = val[idx]
        filled = (p >= CHUNK_OFFSET) & (v != 0)
        interior = p < CHUNK_OFFSET
        if level == depth:
            take = filled | (interior & (v != 0))
            if np.any(take):
                cells.append(np.stack([cx[take], cy[take], cz[take]], axis=1))
                rgbs.append(v[take] & np.uint32(0xFFFFFF))
            break
        # Filled leaves above the bottom expand to their covered block.
        if np.any(filled):
            k = 1 << (depth - level)
            off = np.arange(k, dtype=np.int64)
            ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
            fx = (cx[filled, None] << (depth - level)) + ox.reshape(-1)[None]
            fy = (cy[filled, None] << (depth - level)) + oy.reshape(-1)[None]
            fz = (cz[filled, None] << (depth - level)) + oz.reshape(-1)[None]
            cells.append(
                np.stack([fx.reshape(-1), fy.reshape(-1), fz.reshape(-1)],
                         axis=1)
            )
            rgbs.append(np.repeat(val[idx[filled]] & np.uint32(0xFFFFFF),
                                  k ** 3))
        # Descend interiors.
        di = idx[interior]
        if di.size == 0:
            frontier = (np.zeros(0, np.int64),) * 4
            continue
        # CPU-octree pointers hold the FIRST-CHILD slot directly
        # (core/cpu_octree.py find_voxel; reference src/cpu_octree.rs:48-76).
        base = ptr[di].astype(np.int64)
        child = np.arange(8, dtype=np.int64)
        nidx = (base[:, None] + child[None]).reshape(-1)
        ccx = (cx[interior, None] * 2 + ((child >> 2) & 1)[None]).reshape(-1)
        ccy = (cy[interior, None] * 2 + ((child >> 1) & 1)[None]).reshape(-1)
        ccz = (cz[interior, None] * 2 + (child & 1)[None]).reshape(-1)
        frontier = (nidx, ccx, ccy, ccz)
    if not cells:
        return (np.zeros((0, 3), np.uint32), np.zeros(0, np.uint32))
    c = np.concatenate(cells).astype(np.uint32)
    r = np.concatenate(rgbs).astype(np.uint32)
    assert c.max(initial=0) < side
    return c, r


def tree_depth(tree: CpuOctree) -> int:
    """Depth of the deepest interior frontier + 1 (= the leaf resolution a
    lossless export needs)."""
    ptr = tree.pointers
    idx = np.arange(8, dtype=np.int64)
    depth = 1
    while True:
        di = idx[ptr[idx] < CHUNK_OFFSET]
        if di.size == 0:
            return depth
        idx = (ptr[di].astype(np.int64)[:, None]
               + np.arange(8, dtype=np.int64)[None]).reshape(-1)
        depth += 1


def save_vox(tree: CpuOctree, depth: int | None = None) -> bytes:
    """Serialize ``tree`` at ``2^depth`` resolution to .vox bytes
    (default: the tree's own leaf depth — lossless for .vox imports)."""
    if depth is None:
        depth = tree_depth(tree)
    if depth > 8:
        raise ValueError("MagicaVoxel models cap at 256^3 (depth <= 8)")
    cells, rgb = tree_to_cells(tree, depth)
    size = 1 << depth

    # Palette: 255 most frequent colours; map the rest to the nearest.
    colours, inv, counts = np.unique(rgb, return_inverse=True,
                                     return_counts=True)
    if colours.size > 255:
        keep = np.argsort(-counts)[:255]
        kept = colours[keep]

        def comp(a):
            return np.stack(
                [(a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF], axis=-1
            ).astype(np.int32)

        d = np.abs(comp(colours)[:, None, :] - comp(kept)[None, :, :]).sum(-1)
        remap = np.argmin(d, axis=1)
        inv = remap[inv]
        colours = kept
    palette_idx = inv.astype(np.uint8) + 1  # palette entries are 1-based

    # vox (x, y, z) = (size-1-cx, cz, cy) — inverse of voxels_to_cells.
    vx = (size - 1 - cells[:, 0]).astype(np.uint8)
    vy = cells[:, 2].astype(np.uint8)
    vz = cells[:, 1].astype(np.uint8)
    xyzi = np.stack([vx, vy, vz, palette_idx], axis=1).astype(np.uint8)

    pal = np.zeros(256, dtype="<u4")
    r = colours >> 16 & 0xFF
    g = colours >> 8 & 0xFF
    b = colours & 0xFF
    # Entry i+1 holds colour i: our loader (and the reference via dot_vox,
    # src/cpu_octree.rs:192-194) indexes palette[voxel.i] DIRECTLY, so
    # this offset makes load_vox(save_vox(t)) == t bit-exactly. NOTE:
    # MagicaVoxel's own UI maps display index i to RGBA file entry i-1 —
    # one convention off from dot_vox — so colours may appear shifted one
    # palette slot when editing the file there; the voxel DATA is
    # unaffected and renderer interchange (this repo + the reference) is
    # exact, which is this exporter's contract.
    pal[1: colours.size + 1] = (
        np.uint32(0xFF000000) | (b << 16) | (g << 8) | r
    )  # file order r, g, b, a -> LE word 0xAABBGGRR

    def chunk(cid, content, children=b""):
        return (cid + struct.pack("<ii", len(content), len(children))
                + content + children)

    size_c = chunk(b"SIZE", struct.pack("<iii", size, size, size))
    xyzi_c = chunk(
        b"XYZI", struct.pack("<i", xyzi.shape[0]) + xyzi.tobytes()
    )
    rgba_c = chunk(b"RGBA", pal.tobytes())
    main = chunk(b"MAIN", b"", size_c + xyzi_c + rgba_c)
    return b"VOX " + struct.pack("<i", 150) + main
