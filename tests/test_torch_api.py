"""The port's public names against the JAX package's.

For every module of the JAX package (the ``pkgutil.walk_packages`` list),
every public name the module defines, and every name a subpackage's
``__init__`` imports from its own modules or lists in ``__all__``, resolves
in the port's module of the same path; every public class has each public
method and each constructor parameter; every public function accepts each
parameter. The names read from the JAX sources (``ast``), so a name the
JAX module merely imports from elsewhere is not asked of the port.

What the port leaves out on purpose is listed below, each with its reason;
a test holds every entry to be in JAX and not in the port. Then the new
helpers are held to JAX's on the cases of ``tests/test_voxel.py``,
``tests/test_skip.py`` and ``tests/test_native.py`` (no asset is read).
"""

import ast
import importlib
import inspect
import os
import pkgutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_tracer_tpu
from octree_tracer_tpu.core import CpuOctree as JCpuOctree
from octree_tracer_tpu.core import voxel as jvoxel
from octree_tracer_tpu.io.rsvo import load_rsvo as jload_rsvo
from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu_torch import native
from octree_tracer_tpu_torch.core import voxel
from octree_tracer_tpu_torch.render import skip, tracer

JAX_DIR = os.path.dirname(os.path.abspath(octree_tracer_tpu.__file__))
JAX_MODULES = sorted((m.name.split(".", 1)[1], m.ispkg) for m in pkgutil.walk_packages(
    octree_tracer_tpu.__path__, "octree_tracer_tpu."))
# Modules of the JAX package the port has no counterpart of.
MODULES_OUT = {
    "native.libotcore": "the JAX package's build of the host engine (a shared library, "
                        "not Python); the port builds its own copy (native.py)",
}
# (module, name) left out, with the reason.
NAMES_OUT = {
    ("utils", "xla_trace"): "an XLA profiler span; the port has torch_trace",
    ("utils.timing", "xla_trace"): "an XLA profiler span; the port has torch_trace",
}
# (module, function) -> parameters left out: the port's own forms of the
# same arguments (the value says which).
PARAMS_OUT = {
    ("render.tracer", "trace"): dict(
        with_visits="the port marks a caller's visits tensor in place, where JAX "
                    "returns (result, visits)"),
    ("render.tracer", "shade"): {
        "words": "the port's shade reads the hit words from the result",
        "show_hits_visits": "the port's hits_visits"},
    ("parallel.mesh", "make_mesh"): {
        "devices": "a torch.distributed group, not a JAX device list (group=)",
        "axis": "the port's mesh has the one axis 'rays'"},
}
# The JAX ShardedSession takes **kw for its Session; the port names the same
# keywords explicitly, so its constructor is checked as any other.


def _port_name(rel):
    return "octree_tracer_tpu_torch." + rel


def _tree(rel, ispkg):
    base = os.path.join(JAX_DIR, *rel.split("."))
    with open(os.path.join(base, "__init__.py") if ispkg else base + ".py") as f:
        return ast.parse(f.read())


def _top_level(body):
    """Top-level statements, with those inside top-level if/try blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [s for h in node.handlers for s in h.body])
        else:
            yield node


def _public_names(rel, ispkg):
    """What the JAX module defines (functions, classes, assigned names); for
    a package's ``__init__`` also what it imports from its own modules and
    what ``__all__`` lists."""
    names = set()
    for node in _top_level(_tree(rel, ispkg).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
            if (isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)):
                names.update(ast.literal_eval(node.value))
        elif ispkg and isinstance(node, ast.ImportFrom) and node.level > 0:
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


def _defs(kind):
    out = []
    for rel, ispkg in JAX_MODULES:
        if rel in MODULES_OUT:
            continue
        for node in _tree(rel, ispkg).body:
            if (isinstance(node, kind) and not node.name.startswith("_")
                    and (rel, node.name) not in NAMES_OUT):
                out.append((rel, node.name, ispkg))
    return out


CLASSES = _defs(ast.ClassDef)
FUNCTIONS = _defs(ast.FunctionDef)


def _arg_names(args: ast.arguments):
    return [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]


def _accepts(fn, names):
    """The names among ``names`` that callable ``fn`` takes as keywords."""
    params = inspect.signature(fn).parameters
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return set(names)
    return {n for n in names if n in params}


def test_every_jax_module_is_listed():
    """The walk found the package: every subpackage and the allow-listed
    modules are among the cases."""
    rels = {rel for rel, _ in JAX_MODULES}
    assert len(rels) >= 39 and set(MODULES_OUT) <= rels
    assert {"render.tracer", "core", "adaptive", "world", "native"} <= rels


@pytest.mark.parametrize("rel,ispkg", JAX_MODULES, ids=[r for r, _ in JAX_MODULES])
def test_module_names_resolve(rel, ispkg):
    if rel in MODULES_OUT:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port_name(rel))
        return
    port = importlib.import_module(_port_name(rel))
    jax_mod = importlib.import_module("octree_tracer_tpu." + rel)
    missing = [n for n in _public_names(rel, ispkg)
               if not hasattr(port, n) and (rel, n) not in NAMES_OUT]
    assert not missing, f"{_port_name(rel)} lacks {missing}"
    for n in _public_names(rel, ispkg):
        assert hasattr(jax_mod, n)


@pytest.mark.parametrize("rel,name,ispkg", CLASSES, ids=[f"{r}.{n}" for r, n, _ in CLASSES])
def test_class_methods_resolve(rel, name, ispkg):
    """Every public method (and property) of the JAX class is on the port's
    class, and its constructor takes each of the JAX constructor's
    parameters."""
    node = next(n for n in _tree(rel, ispkg).body
                if isinstance(n, ast.ClassDef) and n.name == name)
    cls = getattr(importlib.import_module(_port_name(rel)), name)
    methods = [b.name for b in node.body if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))]
    missing = [m for m in methods if not m.startswith("_") and not hasattr(cls, m)]
    assert not missing, f"{name} lacks {missing}"
    init = next((b for b in node.body if isinstance(b, ast.FunctionDef)
                 and b.name == "__init__"), None)
    if init is not None and inspect.isclass(cls):
        want = _arg_names(init.args)[1:]
        assert set(want) <= _accepts(cls, want), f"{name}() lacks {set(want) - _accepts(cls, want)}"


@pytest.mark.parametrize("rel,name,ispkg", FUNCTIONS,
                         ids=[f"{r}.{n}" for r, n, _ in FUNCTIONS])
def test_function_parameters_accepted(rel, name, ispkg):
    node = next(n for n in _tree(rel, ispkg).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    out = PARAMS_OUT.get((rel, name), {})
    want = [a for a in _arg_names(node.args) if a not in out]
    fn = getattr(importlib.import_module(_port_name(rel)), name)
    missing = set(want) - _accepts(fn, want)
    assert not missing, f"{_port_name(rel)}.{name} lacks parameters {sorted(missing)}"


def test_allow_list_entries_are_real():
    """Each name, module and parameter left out is in JAX and not in the
    port, so the list cannot hide a name the port has since gained."""
    for (rel, name), reason in NAMES_OUT.items():
        assert reason and hasattr(importlib.import_module("octree_tracer_tpu." + rel), name)
        assert not hasattr(importlib.import_module(_port_name(rel)), name), (rel, name)
    for (rel, name), params in PARAMS_OUT.items():
        jfn = getattr(importlib.import_module("octree_tracer_tpu." + rel), name)
        pfn = inspect.signature(getattr(importlib.import_module(_port_name(rel)), name))
        for p, reason in params.items():
            assert reason and p in inspect.signature(jfn).parameters, (rel, name, p)
            assert p not in pfn.parameters, (rel, name, p)


def test_subpackage_imports():
    from octree_tracer_tpu_torch.adaptive import select_candidates, select_candidates_packed
    from octree_tracer_tpu_torch.core import CpuOctree, Octree
    from octree_tracer_tpu_torch.world import BLOCK_NAMES, World

    from octree_tracer_tpu_torch.adaptive import feedback
    from octree_tracer_tpu_torch.core import cpu_octree, octree
    from octree_tracer_tpu_torch.world import world

    assert select_candidates is feedback.select_candidates
    assert select_candidates_packed is feedback.select_candidates_packed
    assert CpuOctree is cpu_octree.CpuOctree and Octree is octree.Octree
    assert World is world.World and BLOCK_NAMES is world.BLOCK_NAMES


# -- the new helpers against JAX's ------------------------------------------


def test_voxel_constants_and_rgb_roundtrip():
    assert voxel.COUNTER_MAX == jvoxel.COUNTER_MAX == 15
    assert voxel.COUNTER_MASK == jvoxel.COUNTER_MASK and voxel.COUNTER_MASK.dtype == np.uint32
    for r, g, b in [(0, 0, 0), (255, 0, 0), (1, 2, 3), (255, 255, 255)]:
        v = voxel.pack_rgb(r, g, b)
        assert voxel.unpack_rgb(v) == (r, g, b) == jvoxel.unpack_rgb(v)
    rgb = np.random.default_rng(0).integers(0, 1 << 24, 100, dtype=np.uint32)
    for a, b in zip(voxel.unpack_rgb(rgb), jvoxel.unpack_rgb(rgb)):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def test_word_counter_and_is_leaf_word():
    """tests/test_voxel.py's leaf and interior words, and random words with
    every counter value."""
    w = voxel.leaf_word(voxel.pack_rgb(255, 0, 0))
    assert voxel.is_leaf_word(w) and int(voxel.word_counter(w)) == 0
    assert not voxel.is_leaf_word(voxel.interior_word(1234))
    words = np.random.default_rng(1).integers(0, 1 << 32, 4096, dtype=np.uint64)
    words = words.astype(np.uint32)
    words[:16] = voxel.leaf_word(np.arange(16)) | np.arange(16, dtype=np.uint32)
    words[16:32] = voxel.interior_word(np.arange(16)) | np.arange(16, dtype=np.uint32)
    words[32] = np.uint32(voxel.VOXEL_OFFSET << 4)  # the empty leaf
    for fn in ("word_counter", "is_leaf_word"):
        got, want = getattr(voxel, fn)(words), getattr(jvoxel, fn)(words)
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    assert set(voxel.word_counter(words[:32]).tolist()) == set(range(16))


def test_skip_codebook_equals_jax():
    """tests/test_skip.py:55-63: every nibble 0-15 decodes as JAX's, every
    side 0-63 encodes as JAX's, and the decode of the encode is floored and
    exact on codebook values."""
    assert skip.SKIP_CAP == jskip.SKIP_CAP == 32
    nib = torch.arange(16)
    got = skip.decode_skip(nib)
    assert got.tolist() == list(range(13)) + [16, 24, 32]
    assert got.tolist() == np.asarray(jskip.decode_skip(jnp.arange(16, dtype=jnp.uint32))).tolist()
    sides = torch.arange(64, dtype=torch.int32)
    enc = skip.encode_skip(sides)
    assert enc.dtype == torch.int32
    assert enc.tolist() == np.asarray(jskip.encode_skip(jnp.arange(64, dtype=jnp.int32))).tolist()
    back = skip.decode_skip(enc)
    assert bool((back <= torch.clamp(sides, max=skip.SKIP_CAP)).all())
    for cb in list(range(13)) + [16, 24, 32]:
        assert int(back[cb]) == cb


def test_tracer_skip_decode_is_the_codebook():
    """The traversal's plain version decodes a skip word's octant nibble
    through ``skip.decode_skip``: every nibble in every octant."""
    nib = torch.arange(16, dtype=torch.int64)
    for oct_ in range(8):
        words = nib << (4 * oct_)
        got = tracer._decode_skip(words, torch.full_like(nib, oct_))
        assert torch.equal(got, skip.decode_skip(nib))


def test_native_build_leaves_equals_insertion_order():
    """tests/test_native.py:17-34 on random cells of a depth-3 grid: the
    native insertion-order build equals a put_in_voxel loop in the port's
    CpuOctree and in JAX's."""
    assert native.available()
    rng = np.random.default_rng(4)
    cells = rng.integers(0, 8, (60, 3))
    rgb = rng.integers(1, 1 << 24, 60).astype(np.uint32)
    pos = (cells.astype(np.float32) / 8) * 2.0 - 1.0
    from octree_tracer_tpu_torch.core import CHUNK_OFFSET, CpuOctree

    ref, jref = CpuOctree(0), JCpuOctree(0)
    for i in range(cells.shape[0]):
        ref.put_in_voxel(pos[i], rgb[i], 3)
        jref.put_in_voxel(pos[i], rgb[i], 3)
    ptrs, vals = native.build_leaves(pos, np.full(len(rgb), CHUNK_OFFSET, np.uint32), rgb, 3)
    np.testing.assert_array_equal(ptrs, ref.pointers)
    np.testing.assert_array_equal(vals, ref.values)
    np.testing.assert_array_equal(ptrs, jref.pointers)
    np.testing.assert_array_equal(vals, jref.values)
    with pytest.raises(ValueError):
        native.build_leaves(pos, rgb[:3], rgb, 3)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_native_load_rsvo_masks_equals_python(depth):
    """tests/test_native.py:37-52: the native mask expansion equals the
    Python ``load_rsvo`` of the port and of JAX, at each depth of the
    stream."""
    from octree_tracer_tpu_torch.io.rsvo import load_rsvo

    top_level = 3
    masks = bytes([0b00000011, 0b00000101, 0b11111111, 0b1, 0b1, 0b1, 0b1, 0b1])
    counts = (1, 2, 5, 0)
    data = b"\x00" * 16 + bytes([top_level]) + b"\x00" * 3 + struct.pack("<IIII", *counts)
    data += masks
    py, jpy = load_rsvo(data, depth), jload_rsvo(data, depth)
    ptrs, vals = native.load_rsvo_masks(np.frombuffer(masks, dtype=np.uint8),
                                        sum(counts[:depth]))
    for got, want in ((ptrs, py.pointers), (vals, py.values), (ptrs, jpy.pointers),
                      (vals, jpy.values)):
        np.testing.assert_array_equal(got, want)


def test_cpu_octree_raw_equals_jax():
    from octree_tracer_tpu_torch.core import CpuOctree

    rng = np.random.default_rng(2)
    t, jt = CpuOctree(0), JCpuOctree(0)
    for c in rng.integers(0, 16, (40, 3)):
        p = (c + 0.5) / 16 * 2 - 1
        t.put_in_block(p, 3, 4)
        jt.put_in_block(p, 3, 4)
    raw = t.raw()
    np.testing.assert_array_equal(raw, jt.raw())
    assert raw.dtype == jt.raw().dtype
    raw[0] = 7  # a copy
    assert t.pointers[0] != 7 or jt.pointers[0] == 7


def test_encode_u8_equals_jax():
    """``encode_u8`` against JAX's by the u8 rule of test_torch_render.py
    (at least 99.9% equal, never more than 1 apart: XLA's CPU ``pow``
    rounds a few knife-edge values the other way), equal to the port's
    own encode, shape kept, values past [0, 1] clipped."""
    rng = np.random.default_rng(7)
    img = rng.random((64, 48, 3), dtype=np.float32)
    img[0, :4, 0] = [-1.0, 0.0, 1.0, 2.0]
    got = tracer.encode_u8(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and got.shape == img.shape
    assert torch.equal(got, tracer.encode_u8_plain(torch.from_numpy(img)))
    want = np.asarray(jtracer.encode_u8(jnp.asarray(img)))
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    assert got[0, :4, 0].tolist() == [0, 0, 255, 255]
    with pytest.raises(TypeError):
        tracer.encode_u8(torch.from_numpy(img).double())
