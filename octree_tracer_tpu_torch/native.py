"""ctypes bindings for the host engine library (``libotcore``).

The library is built from the port's own copy of the engine,
``csrc/host/otcore.cpp`` (byte-equal to the JAX package's
``native/otcore.cpp``; a test holds the two equal). It lies outside the
``csrc/*.cu`` set that ``kernels.py`` hands to ``nvcc``. It is compiled at
first use with ``g++ -O2 -std=c++17 -fPIC -shared`` into ``_build/`` beside
this file, under a name keyed on a hash of the source, so an edit rebuilds
it. Importing this module builds nothing. Without a compiler,
``available()`` is False and the callers take their NumPy paths.

Bound here: the batch adaptive engine (``otc_process_subdivision`` and
``otc_process_unsubdivision``, driven by ``app.native_engine``), the mip
tree (``patch_refs``, ``mip_tree``, used by ``world.World``), the dense
chunk build (``build_dense``, used by ``gen.procedural``), the batch
leaf insert into an existing chunk (``stamp_leaves``, used by
``gen.structures``), and, for callers of the JAX package's API, the
insertion-order build (``build_leaves``) and the ``.rsvo`` mask expansion
(``load_rsvo_masks``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "host", "otcore.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib = None
_tried = False


class OtPool(ctypes.Structure):
    _fields_ = [
        ("nodes", ctypes.POINTER(ctypes.c_uint32)),
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("len", ctypes.c_uint64),
        ("cap", ctypes.c_uint64),
        ("holes", ctypes.POINTER(ctypes.c_uint32)),
        ("hole_len", ctypes.c_uint64),
        ("hole_cap", ctypes.c_uint64),
    ]


class OtChunk(ctypes.Structure):
    _fields_ = [
        ("id", ctypes.c_uint32),
        ("n", ctypes.c_uint32),
        ("ptrs", ctypes.POINTER(ctypes.c_uint32)),
        ("vals", ctypes.POINTER(ctypes.c_uint32)),
    ]


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libotcore_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this source hash is already built; return
    its path. Raises if there is no source or no compiler, or g++ fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed with code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load():
    """The loaded library, built first if needed; None if it cannot be
    built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError):
        return None
    lib.otc_process_subdivision.restype = ctypes.c_int64
    lib.otc_process_unsubdivision.restype = ctypes.c_int64
    lib.otc_mip_tree.restype = ctypes.c_uint32
    lib.otc_patch_refs.restype = None
    lib.otc_build_dense.restype = ctypes.c_void_p
    lib.otc_build_dense.argtypes = [ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32]
    lib.otc_stamp_leaves.restype = ctypes.c_void_p
    lib.otc_stamp_leaves.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64, ctypes.c_uint32]
    lib.otc_build_leaves.restype = ctypes.c_void_p
    lib.otc_build_leaves.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64, ctypes.c_uint32]
    lib.otc_load_rsvo.restype = ctypes.c_void_p
    lib.otc_load_rsvo.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                                  ctypes.c_uint64]
    lib.otc_buf_len.restype = ctypes.c_uint64
    lib.otc_buf_len.argtypes = [ctypes.c_void_p]
    lib.otc_buf_copy.restype = None
    lib.otc_buf_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
                                 ctypes.POINTER(ctypes.c_uint32)]
    lib.otc_buf_free.restype = None
    lib.otc_buf_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def chunk_views(world) -> tuple:
    """OtChunk views over a World's resident chunks: (ctypes array, count,
    keepalive list). The chunk dict is copied in one step first: a chunk
    load finishing on the World's IO pool inserts into it, and iterating
    the live dict across that insert raises."""
    items = [(cid, c) for cid, c in list(world.chunks.items()) if len(c) >= 8]
    arr = (OtChunk * max(1, len(items)))()
    keep = []
    for i, (cid, c) in enumerate(items):
        ptrs = np.ascontiguousarray(c.pointers)
        vals = np.ascontiguousarray(c.values)
        keep.append((ptrs, vals))
        arr[i] = OtChunk(np.uint32(cid), np.uint32(len(c)), _u32p(ptrs), _u32p(vals))
    return arr, len(items), keep


def patch_refs(pointers: np.ndarray, values: np.ndarray,
               ids: np.ndarray, mips: np.ndarray) -> None:
    """Write each referenced chunk's top-mip colour into the values of the
    nodes referencing it (one linear pass)."""
    lib = load()
    assert values.flags["C_CONTIGUOUS"]
    order = np.argsort(ids, kind="stable")
    ids = np.ascontiguousarray(ids[order], dtype=np.uint32)
    mips = np.ascontiguousarray(mips[order], dtype=np.uint32)
    lib.otc_patch_refs(
        _u32p(np.ascontiguousarray(pointers)), _u32p(values),
        ctypes.c_uint64(pointers.shape[0]),
        _u32p(ids), _u32p(mips), ctypes.c_uint32(ids.shape[0]),
    )


def mip_tree(pointers: np.ndarray, values: np.ndarray) -> int:
    """In-place bottom-up mip averaging; returns the top mip colour. Chunk-ref
    values must be patched first (``patch_refs``)."""
    lib = load()
    assert values.flags["C_CONTIGUOUS"]
    return int(lib.otc_mip_tree(
        _u32p(np.ascontiguousarray(pointers)), _u32p(values),
        ctypes.c_uint64(pointers.shape[0]),
    ))


def _take_buf(lib, h) -> tuple[np.ndarray, np.ndarray]:
    """Copy a library buffer out as (pointers, values) and free it."""
    n = lib.otc_buf_len(h)
    ptrs = np.empty(n, dtype=np.uint32)
    vals = np.empty(n, dtype=np.uint32)
    lib.otc_buf_copy(h, _u32p(ptrs), _u32p(vals))
    lib.otc_buf_free(h)
    return ptrs, vals


def stamp_leaves(ptrs: np.ndarray, vals: np.ndarray, pos: np.ndarray,
                 leaf_ptrs: np.ndarray, leaf_vals: np.ndarray,
                 depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Insert leaves (``leaf_ptrs[i]``, ``leaf_vals[i]``) at the positions
    ``pos`` f32[M, 3] and ``depth``, in order, into a copy of the tree
    (``ptrs``, ``vals``); returns the new (pointers, values), the arrays a
    ``CpuOctree.put_in_block`` loop in the same order leaves."""
    lib = load()
    ptrs = np.ascontiguousarray(ptrs, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    pos = np.ascontiguousarray(pos, dtype=np.float32).reshape(-1, 3)
    leaf_ptrs = np.ascontiguousarray(leaf_ptrs, dtype=np.uint32)
    leaf_vals = np.ascontiguousarray(leaf_vals, dtype=np.uint32)
    if not pos.shape[0] == leaf_ptrs.shape[0] == leaf_vals.shape[0]:
        raise ValueError("pos, leaf_ptrs and leaf_vals must have one entry per leaf")
    if ptrs.shape != vals.shape:
        raise ValueError("ptrs and vals must have the same length")
    h = lib.otc_stamp_leaves(_u32p(ptrs), _u32p(vals), ptrs.shape[0], _f32p(pos),
                             _u32p(leaf_ptrs), _u32p(leaf_vals), pos.shape[0], depth)
    return _take_buf(lib, h)


def build_dense(packed: np.ndarray, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Level-synchronous octree build from a 2-bit-packed S^3 block-id grid
    (S = 2^depth, flat C-order cells, 16 per u32, cell i in bits
    [2i, 2i+1]): the tree of the grid's occupied cells as block-reference
    leaves (``CHUNK_OFFSET + id``, 0) in breadth-first morton layout.
    ``packed`` may hold the words as u32 or as int32 bits. Returns
    (pointers, values)."""
    lib = load()
    packed = np.ascontiguousarray(packed).reshape(-1)
    if packed.dtype not in (np.uint32, np.int32):
        raise TypeError(f"packed must be u32 or int32 words, got {packed.dtype}")
    packed = packed.view(np.uint32)
    expect = (1 << (3 * depth)) // 16
    if packed.shape[0] != expect:
        raise ValueError(f"packed grid has {packed.shape[0]} words, "
                         f"expected {expect} for depth {depth}")
    return _take_buf(lib, lib.otc_build_dense(_u32p(packed), ctypes.c_uint32(depth)))


def build_leaves(pos: np.ndarray, leaf_ptrs: np.ndarray, leaf_vals: np.ndarray,
                 depth: int) -> tuple[np.ndarray, np.ndarray]:
    """A new tree of the leaves (``leaf_ptrs[i]``, ``leaf_vals[i]``) at the
    positions ``pos`` f32[M, 3] and ``depth``, inserted in order: the
    (pointers, values) of a ``CpuOctree(0)`` after a ``put_in_voxel`` /
    ``put_in_block`` loop in the same order."""
    lib = load()
    pos = np.ascontiguousarray(pos, dtype=np.float32).reshape(-1, 3)
    leaf_ptrs = np.ascontiguousarray(leaf_ptrs, dtype=np.uint32)
    leaf_vals = np.ascontiguousarray(leaf_vals, dtype=np.uint32)
    if not pos.shape[0] == leaf_ptrs.shape[0] == leaf_vals.shape[0]:
        raise ValueError("pos, leaf_ptrs and leaf_vals must have one entry per leaf")
    return _take_buf(lib, lib.otc_build_leaves(_f32p(pos), _u32p(leaf_ptrs),
                                               _u32p(leaf_vals), pos.shape[0], depth))


def load_rsvo_masks(masks: np.ndarray, node_end: int) -> tuple[np.ndarray, np.ndarray]:
    """The breadth-first expansion of an ``.rsvo`` child-mask stream (one
    byte a node, the root's first): each block reference in breadth-first
    order takes the next mask byte and becomes a child group while the
    byte's place in the stream is below ``node_end`` (the node count of the
    levels above the depth loaded, as ``io.rsvo.load_rsvo`` counts it).
    Returns (pointers, values), the arrays ``io.rsvo.load_rsvo`` builds."""
    lib = load()
    masks = np.ascontiguousarray(masks, dtype=np.uint8).reshape(-1)
    return _take_buf(lib, lib.otc_load_rsvo(
        masks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), masks.shape[0], node_end))
