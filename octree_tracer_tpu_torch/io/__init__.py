"""Scene/asset loaders (.vox, .rsvo, world .bin chunks): the JAX package's
``io`` package, host NumPy, copied so that the port imports no module of
that package (``tests/test_torch_io.py`` holds each copy to the original)."""

from __future__ import annotations

import os

from ..core.cpu_octree import CpuOctree
from .rsvo import RsvoError, load_rsvo
from .rsvo_export import save_rsvo
from .vox import VoxError, load_structure, load_vox, parse_vox


def load_file(path: str, octree_depth: int = 0) -> CpuOctree:
    """Dispatch by extension (reference: src/cpu_octree.rs:113-125)."""
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        data = f.read()
    if ext == ".rsvo":
        return load_rsvo(data, octree_depth)
    if ext == ".vox":
        return load_vox(data)
    if ext == ".bin":
        # A saved world chunk (world/<id>.bin) — lets the export/render CLI
        # operate on streamed chunks directly.
        return CpuOctree.from_bin(data)
    raise ValueError("Unknown file type")


__all__ = [
    "CpuOctree",
    "RsvoError",
    "VoxError",
    "load_file",
    "load_rsvo",
    "save_rsvo",
    "load_structure",
    "load_vox",
    "parse_vox",
]
