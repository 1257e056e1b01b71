"""Host layer of the port: its copies of ``CpuOctree``, ``Octree``,
``World`` and both adaptive engines hold the JAX package's originals on the
same inputs, and the deep shell as a streaming world equals the bench pool
word for word."""

import ctypes
import json
import os

import numpy as np
import pytest

from octree_tracer_tpu import native as jnative
from octree_tracer_tpu.adaptive import engine as jengine
from octree_tracer_tpu.app import native_engine as jnative_engine
from octree_tracer_tpu.core import CpuOctree as JCpuOctree
from octree_tracer_tpu.core import voxel as jvoxel
from octree_tracer_tpu.core.octree import Octree as JOctree
from octree_tracer_tpu.world.world import World as JWorld
from octree_tracer_tpu_torch import kernels, native, scenes, state
from octree_tracer_tpu_torch.adaptive import engine
from octree_tracer_tpu_torch.app import native_engine
from octree_tracer_tpu_torch.core import voxel
from octree_tracer_tpu_torch.core.cpu_octree import CpuOctree
from octree_tracer_tpu_torch.core.octree import Octree, node_depth
from octree_tracer_tpu_torch.io.vox import build_octree_leaves
from octree_tracer_tpu_torch.world.world import World


def test_voxel_helpers_equal_jax_package():
    rgb = np.array([0, 1, 0xABCDEF, 0xFFFFFF], np.uint32)
    np.testing.assert_array_equal(voxel.leaf_word(rgb), jvoxel.leaf_word(rgb))
    np.testing.assert_array_equal(voxel.interior_word(rgb), jvoxel.interior_word(rgb))
    words = jvoxel.leaf_word(rgb)
    np.testing.assert_array_equal(voxel.word_payload(words), jvoxel.word_payload(words))
    assert voxel.pack_rgb(1, 2, 3) == jvoxel.pack_rgb(1, 2, 3)
    assert voxel.CHUNK_OFFSET == jvoxel.CHUNK_OFFSET
    assert voxel.VOXEL_OFFSET == int(jvoxel.VOXEL_OFFSET)
    for depth in (1, 3, 7):
        np.testing.assert_array_equal(voxel.child_offset(np.arange(8), depth),
                                      jvoxel.child_offset(np.arange(8), depth))


def _cpu_ops(tree, rng, depth):
    """Block references by ascending depth, then voxels at ``depth``: an
    insert never lands above a deeper node on its path (both packages'
    ``put_in_block`` would split forever there)."""
    blocks = sorted(((int(rng.integers(1, depth)), int(rng.integers(1, 9)),
                      rng.uniform(-1, 1, 3).astype(np.float32)) for _ in range(8)),
                    key=lambda op: op[0])
    for d, block_id, pos in blocks:
        tree.put_in_block(pos, block_id, d)
    for _ in range(32):
        tree.put_in_voxel(rng.uniform(-1, 1, 3).astype(np.float32),
                          int(rng.integers(0, 1 << 24)), depth)
    return tree


@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_octree_equals_jax_package(seed):
    a = _cpu_ops(CpuOctree(0b1010_0101), np.random.default_rng(seed), 5)
    b = _cpu_ops(JCpuOctree(0b1010_0101), np.random.default_rng(seed), 5)
    np.testing.assert_array_equal(a.pointers, b.pointers)
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.to_words(), b.to_words())
    assert a.to_bin() == b.to_bin()
    assert a.top_mip == b.top_mip
    c = CpuOctree.from_bin(a.to_bin())
    np.testing.assert_array_equal(c.pointers, a.pointers)
    for p in np.random.default_rng(seed + 9).uniform(-1, 1, (20, 3)).astype(np.float32):
        ia, da, ca = a.find_voxel(p)
        ib, db, cb = b.find_voxel(p)
        assert (ia, da) == (ib, db)
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(a.get_node_mask(ia - ia % 8),
                                      b.get_node_mask(ib - ib % 8))


def _live(tree):
    """Slots reachable from the root group: what a frame can visit, so what
    the Session's candidates name (freed groups keep stale words)."""
    slots, frontier = [], [0]
    while frontier:
        base = frontier.pop()
        for slot in range(base, base + 8):
            slots.append(slot)
            payload = tree.get_node(slot)
            if payload < int(jvoxel.VOXEL_OFFSET):
                frontier.append(payload)
    return np.sort(np.asarray(slots, dtype=np.int64))


def _octree_ops(tree, rng):
    """Random subdivides and collapses of live nodes; returns the drained
    journals."""
    out = []
    for step in range(60):
        live = _live(tree)
        leaves = [i for i in live if tree.get_node(i) >= int(jvoxel.VOXEL_OFFSET)]
        inner = [i for i in live if tree.get_node(i) < int(jvoxel.VOXEL_OFFSET)]
        if inner and rng.random() < 0.3:
            node = inner[rng.integers(len(inner))]
            tree.unsubdivide(node)
            tree.set_leaf(node, int(rng.integers(1 << 24)))
        else:
            node = leaves[rng.integers(len(leaves))]
            depth = tree.find_voxel(tree.positions[node])[1]
            tree.subdivide(node, rng.integers(0, 1 << 24, 8).astype(np.uint32), depth + 1)
        if step % 10 == 9:
            out.append((tree.drain_patches(), tree.drain_freed()))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_octree_equals_jax_package(seed):
    mask = np.arange(8, dtype=np.uint32) * 1000 + 7
    a, b = Octree(mask), JOctree(mask)
    ja, jb = _octree_ops(a, np.random.default_rng(seed)), _octree_ops(b, np.random.default_rng(seed))
    np.testing.assert_array_equal(a.nodes, b.nodes)
    np.testing.assert_array_equal(a.positions, b.positions)
    assert a.hole_stack == b.hole_stack
    assert a.hole_fraction() == b.hole_fraction()
    np.testing.assert_array_equal(a.expanded(len(a) + 8), b.expanded(len(b) + 8))
    for ((ia, va), fa), ((ib, vb), fb) in zip(ja, jb):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(fa, fb)
    # max_depth is the deepest node the tree has held; node_depth reads a
    # live node's depth back from its dyadic centre.
    live = _live(a)
    depths = node_depth(a.positions[live])
    assert a.max_depth >= int(depths.max()) > 1
    for i, depth in zip(live, depths):
        if a.get_node(i) >= int(jvoxel.VOXEL_OFFSET):  # a leaf
            assert a.find_voxel(a.positions[i])[:2] == (i, depth)


def test_octree_rejects_bad_masks_and_double_subdivide():
    with pytest.raises(ValueError):
        Octree(np.zeros(7, np.uint32))
    t = Octree(np.ones(8, np.uint32))
    t.subdivide(3, np.ones(8, np.uint32), 2)
    assert t.max_depth == 2
    with pytest.raises(ValueError):
        t.subdivide(3, np.ones(8, np.uint32), 2)


@pytest.mark.parametrize("depth", [1, 3, 5, 7])
def test_shell_chunk_is_deep_shell(depth):
    chunk = scenes.shell_chunk(depth)
    np.testing.assert_array_equal(chunk.to_words(), scenes.deep_shell(depth))
    world = scenes.shell_world(depth)
    np.testing.assert_array_equal(world.chunks[0].to_words(), scenes.deep_shell(depth))


def _ref_world():
    """A root chunk (shell, depth 5) with chunk references to two chunks,
    one of them generated terrain, in both packages."""
    root = scenes.chunk_from_words(scenes.deep_shell(5))
    gen_id = int(voxel.CHUNK_OFFSET) // 2 + 3
    ptrs, vals = root.pointers.copy(), root.values.copy()
    leaves = np.flatnonzero(ptrs == voxel.CHUNK_OFFSET)
    ptrs[leaves[::7]] = voxel.CHUNK_OFFSET + np.uint32(2)
    ptrs[leaves[3::11]] = voxel.CHUNK_OFFSET + np.uint32(gen_id)
    chunks = {
        0: (ptrs, vals, 0),
        2: (scenes.chunk_from_words(scenes.deep_shell(3)).pointers,
            scenes.chunk_from_words(scenes.deep_shell(3)).values, 0x123456),
        gen_id: (scenes.chunk_from_words(scenes.random_scene(3, 30, 5)).pointers,
                 scenes.chunk_from_words(scenes.random_scene(3, 30, 5)).values, 0x654321),
    }
    return chunks


def _jax_world(chunks):
    w = JWorld(load_blocks=False)
    for cid, (p, v, t) in chunks.items():
        w.chunks[cid] = JCpuOctree.from_arrays(p, v, top_mip=t)
    return w


@pytest.mark.parametrize("use_native", [True, False])
def test_generate_mip_tree_equals_jax_package(use_native, monkeypatch):
    chunks = _ref_world()
    a, b = state.world_from_numpy(chunks), _jax_world(chunks)
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert native.available() and jnative.available()
    for cid in sorted(chunks, reverse=True):
        a.generate_mip_tree(cid)
        b.generate_mip_tree(cid)
    got, want = state.world_to_numpy(a), state.world_to_numpy(b)
    assert got.keys() == want.keys()
    for cid in got:
        for x, y in zip(got[cid], want[cid]):
            np.testing.assert_array_equal(x, y)


def test_world_find_voxel_and_chunk_io(tmp_path):
    chunks = _ref_world()
    a, b = state.world_from_numpy(chunks), _jax_world(chunks)
    for p in np.random.default_rng(2).uniform(-1, 1, (40, 3)).astype(np.float32):
        ra, rb = a.find_voxel(p), b.find_voxel(p)
        assert ra[:3] == rb[:3]
        np.testing.assert_array_equal(ra[3], rb[3])
    a.path = str(tmp_path)
    a.save_chunk(2)
    a.evict_chunk(2)
    assert 2 not in a.chunks
    a.load_chunk(2)
    a._pool.shutdown(wait=True)
    np.testing.assert_array_equal(a.chunks[2].pointers, chunks[2][0])
    a.save_chunk(0)
    c = World.load_world(str(tmp_path), load_blocks=False)
    np.testing.assert_array_equal(c.chunks[0].pointers, chunks[0][0])
    with pytest.raises(FileNotFoundError):
        World.load_world(str(tmp_path / "missing"), load_blocks=False)
    # The block library loads by default, as JAX's: from an asset root
    # without blocks/ it raises as JAX's does.
    with pytest.raises(FileNotFoundError):
        World(asset_root=str(tmp_path / "no_assets"))
    with pytest.raises(FileNotFoundError):
        JWorld(asset_root=str(tmp_path / "no_assets"))


def _engine_run(pkg_octree, world, eng_sub, eng_unsub, seed, journals=None):
    """Six batches of splits and collapses of live nodes; with ``journals``,
    each step's drained patches, drained freed slots and hole stack are
    appended to it."""
    rng = np.random.default_rng(seed)
    t = pkg_octree(world.chunks[0].get_node_mask(0))
    stats = []
    for step in range(6):
        live = _live(t)
        n = live.shape[0]
        cand = rng.permutation(live)[: max(4, n // 2)].astype(np.int32)
        if step % 3 == 2:
            stats.append(eng_unsub(cand[: n // 8], t, world))
        else:
            stats.append(eng_sub(np.append(cand, -1), t, world))
        if journals is not None:
            journals.append((t.drain_patches(), t.drain_freed(), list(t.hole_stack)))
    return t, stats


def _first(x):
    return x[0] if isinstance(x, tuple) else x


@pytest.mark.parametrize("engine_name", ["python", "native"])
def test_engines_equal_jax_package(engine_name):
    chunks = _ref_world()
    del chunks[int(voxel.CHUNK_OFFSET) // 2 + 3]  # a missing chunk on some paths
    a_w, b_w = state.world_from_numpy(chunks), _jax_world(chunks)
    for w in (a_w, b_w):
        w.generate_mip_tree(2)
        w.generate_mip_tree(0)
    if engine_name == "python":
        ours = (engine.process_subdivision, engine.process_unsubdivision)
    else:
        ours = (native_engine.process_subdivision, native_engine.process_unsubdivision)
    a, sa = _engine_run(Octree, a_w, *ours, seed=7)
    b, sb = _engine_run(JOctree, b_w, jengine.process_subdivision,
                        jengine.process_unsubdivision, seed=7)
    assert [_first(x) for x in sa] == [_first(x) for x in sb]
    assert sum(_first(x) for x in sa) > 0
    np.testing.assert_array_equal(a.nodes, b.nodes)
    np.testing.assert_array_equal(a.positions, b.positions)
    assert a.hole_stack == b.hole_stack
    np.testing.assert_array_equal(a.drain_patches()[0], b.drain_patches()[0])
    np.testing.assert_array_equal(a.drain_freed(), b.drain_freed())
    assert a.max_depth == int(node_depth(a.positions[_live(a)]).max())


def test_native_engine_equals_jax_native_engine():
    """The port's bridge journals the library's patches as one array and cuts
    or extends the hole stack; JAX's marks one slot a patch and rebuilds the
    stack. Every step's drained patches are equal byte for byte; JAX's bridge
    journals no freed group, so the port's freed slots are those of the
    groups the step pushed on JAX's hole stack."""
    chunks = _ref_world()
    a_w, b_w = state.world_from_numpy(chunks), _jax_world(chunks)
    ja, jb = [], []
    a, sa = _engine_run(Octree, a_w, native_engine.process_subdivision,
                        native_engine.process_unsubdivision, seed=11, journals=ja)
    b, sb = _engine_run(JOctree, b_w, jnative_engine.process_subdivision,
                        jnative_engine.process_unsubdivision, seed=11, journals=jb)
    assert [_first(x) for x in sa] == [_first(x) for x in sb]
    np.testing.assert_array_equal(a.nodes, b.nodes)
    assert a.hole_stack == b.hole_stack
    assert sorted(a_w.chunks) == sorted(b_w.chunks)
    held, freed = [], 0
    for ((ia, va), fa, ha), ((ib, vb), fb, hb) in zip(ja, jb):
        assert ia.size and ia.dtype == ib.dtype and va.dtype == vb.dtype
        assert ia.tobytes() == ib.tobytes() and va.tobytes() == vb.tobytes()
        assert ha == hb and fb.size == 0
        pushed = np.asarray(hb[len(held):], dtype=np.int64)
        np.testing.assert_array_equal(fa, (pushed[:, None] + np.arange(8)).reshape(-1))
        held, freed = hb, freed + fa.size
    assert freed > 0


class _SlotJournal(Octree):
    """The port's octree beside a per-slot reference journal: a span a
    ``_mark``, and one ``(slot, slot + 1)`` span a slot of each array, as
    the bridge marked each patched slot alone, drained one ``arange`` a
    span; and the deepest of every marked slot's depth."""

    def __init__(self, mask):
        super().__init__(mask)
        self.ref, self.ref_depth = [], 1

    def _mark(self, start, stop):
        super()._mark(start, stop)
        self._ref_marks([(int(start), int(stop))])

    def mark_slots(self, slots):
        super().mark_slots(slots)
        self._ref_marks([(int(i), int(i) + 1) for i in slots])

    def _ref_marks(self, spans):
        self.ref.extend(spans)
        for a, b in spans:
            self.ref_depth = max(self.ref_depth, int(node_depth(self._positions[a:b]).max()))

    def drain_reference(self):
        spans, self.ref = self.ref, []
        if not spans:
            return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.uint32)
        idx = np.unique(np.concatenate([np.arange(a, b, dtype=np.int32) for a, b in spans]))
        return idx, self._nodes[idx]


ENGINES = {"python": (engine.process_subdivision, engine.process_unsubdivision),
           "native": (native_engine.process_subdivision, native_engine.process_unsubdivision)}


def _mip_world():
    world = state.world_from_numpy(_ref_world())
    for cid in sorted(world.chunks, reverse=True):
        world.generate_mip_tree(cid)
    return world


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("engines", ["native", "python", "mixed"])
def test_patch_journal_equals_per_slot_journal(engines, seed):
    """Random batches through each engine, and both engines' batches in one
    drain ("mixed": the Python engine's spans beside the library's arrays).
    Each drain holds slots patched twice: nodes split, then some of them
    collapsed, then split again from the groups they freed. The drained
    (idx, vals) equal the per-slot journal's byte for byte, idx sorted and
    unique; an empty drain is empty."""
    world = _mip_world()
    rng = np.random.default_rng(seed)
    tree = _SlotJournal(world.chunks[0].get_node_mask(0))
    for idx, vals in (tree.drain_patches(), tree.drain_patches()):
        assert idx.dtype == np.int32 and vals.dtype == np.uint32 and idx.size == vals.size == 0
    drains = 0
    for step in range(9):
        if engines == "mixed":  # the other engine collapses
            kinds = ("python", "native") if step % 2 else ("native", "python")
        else:
            kinds = (engines, engines)
        sub, unsub = ENGINES[kinds[0]][0], ENGINES[kinds[1]][1]
        live = _live(tree)
        cand = rng.permutation(live)[:48].astype(np.int32)
        assert _first(sub(np.append(cand, -1), tree, world)) > 0
        split = np.asarray([c for c in cand if tree.get_node(c) < int(voxel.VOXEL_OFFSET)],
                           dtype=np.int32)
        back = split[: max(1, split.size // 3)]
        assert _first(unsub(back, tree, world)) == back.size
        sub(back, tree, world)  # split again, from the groups just freed
        if step % 3 == 2:
            marked = sum(b - a for a, b in tree.ref)
            idx, vals = tree.drain_patches()
            want_idx, want_vals = tree.drain_reference()
            assert idx.dtype == np.int32 and vals.dtype == np.uint32
            assert idx.tobytes() == want_idx.tobytes() and vals.tobytes() == want_vals.tobytes()
            assert np.all(np.diff(idx) > 0) and marked > idx.size
            drains += 1
    assert drains == 3 and tree.max_depth == tree.ref_depth > 1
    idx, vals = tree.drain_patches()
    assert idx.dtype == np.int32 and vals.dtype == np.uint32 and idx.size == vals.size == 0


def test_journal_reads_one_span_a_slot_after_a_native_subdivision():
    """What a caller that walks the journal sees: after the library's batch,
    ``_dirty[first:]`` yields one ``(slot, slot + 1)`` pair a patched slot,
    each split's node then its 8 children; ``_mark`` still journals a slot,
    and the drain holds both."""
    world = _mip_world()
    tree = Octree(world.chunks[0].get_node_mask(0))
    tree._mark(3, 4)
    first = len(tree._dirty)
    applied, _ = native_engine.process_subdivision(np.arange(8, dtype=np.int32), tree, world)
    pairs = tree._dirty[first:]
    assert applied > 0 and len(pairs) == 9 * applied == len(tree._dirty) - first
    assert all(b == a + 1 for a, b in pairs) and list(tree._dirty)[first:] == pairs
    for k in range(applied):
        node, kids = pairs[9 * k][0], [a for a, _ in pairs[9 * k + 1: 9 * k + 9]]
        assert tree.get_node(node) == kids[0] and kids == list(range(kids[0], kids[0] + 8))
    slot = kids[0] + 8
    tree._mark(slot, slot + 1)
    assert len(tree._dirty) == first + 9 * applied + 1 and tree._dirty[-1] == (slot, slot + 1)
    idx, _ = tree.drain_patches()
    assert idx.tolist() == sorted({3, slot} | {a for a, _ in pairs})
    assert len(tree._dirty) == 0 and list(tree._dirty) == []


def test_native_library_builds_from_the_jax_source():
    """The host engine builds from the port's own copy of the JAX package's
    ``native/otcore.cpp``, byte for byte, inside the port."""
    port_dir = os.path.dirname(os.path.abspath(native.__file__))
    assert os.path.commonpath([port_dir, os.path.abspath(native.SOURCE)]) == port_dir
    jax_source = os.path.join(os.path.dirname(os.path.abspath(jnative.__file__)), "otcore.cpp")
    with open(native.SOURCE, "rb") as a, open(jax_source, "rb") as b:
        assert a.read() == b.read()
    assert native.SOURCE not in kernels.sources()
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR)
    lib = native.load()
    assert lib is not None and isinstance(lib, ctypes.CDLL)
    assert native.available()


def test_world_round_trip_through_numpy():
    chunks = _ref_world()
    b = _jax_world(chunks)
    b.generate_mip_tree(0)
    a = state.world_from_numpy(state.world_to_numpy(b))
    assert isinstance(a, World)
    for cid, c in b.chunks.items():
        np.testing.assert_array_equal(a.chunks[cid].pointers, c.pointers)
        np.testing.assert_array_equal(a.chunks[cid].values, c.values)
        assert a.chunks[cid].top_mip == c.top_mip


@pytest.mark.parametrize("depth", [2, 4, 5])
def test_build_dense_equals_jax_binding(depth):
    """``native.build_dense`` against the JAX package's binding on random
    packed grids (block ids 0-3, about a third of the cells filled), and on
    int32 words of the same bits, and on the NumPy level build of the same
    cells."""
    rng = np.random.default_rng(depth)
    cells = rng.choice(4, size=1 << (3 * depth), p=[0.66, 0.17, 0.0, 0.17]).astype(np.uint32)
    packed = (cells.reshape(-1, 16) << (2 * np.arange(16, dtype=np.uint32))).sum(
        axis=1, dtype=np.uint32)
    ptrs, vals = native.build_dense(packed, depth)
    jptrs, jvals = jnative.build_dense(packed, depth)
    np.testing.assert_array_equal(ptrs, jptrs)
    np.testing.assert_array_equal(vals, jvals)
    ptrs_i, _ = native.build_dense(packed.view(np.int32), depth)
    np.testing.assert_array_equal(ptrs_i, jptrs)
    tree = build_octree_leaves(
        np.argwhere(cells.reshape((1 << depth,) * 3) > 0),
        voxel.CHUNK_OFFSET + cells[cells > 0], np.zeros(int((cells > 0).sum()), np.uint32),
        depth)
    np.testing.assert_array_equal(tree.pointers, ptrs)
    with pytest.raises(ValueError):
        native.build_dense(packed[:-1], depth)
    with pytest.raises(TypeError):
        native.build_dense(packed.astype(np.float32), depth)


@pytest.fixture(scope="module")
def asset_root(tmp_path_factory):
    return scenes.write_asset_root(str(tmp_path_factory.mktemp("assets")), seed=3)


def test_block_library_equals_jax(asset_root):
    """``World(load_blocks=True)`` loads ``<asset_root>/blocks/<name>.vox``
    as chunks 1-8 with their mip trees: every chunk's pointers, values and
    top mip equal JAX's."""
    import inspect

    params = inspect.signature(World).parameters
    assert params["load_blocks"].default is True  # as JAX's
    from octree_tracer_tpu_torch.world.world import BLOCK_NAMES
    from octree_tracer_tpu.world.world import BLOCK_NAMES as JBLOCK_NAMES

    assert BLOCK_NAMES == JBLOCK_NAMES
    a, b = World(asset_root=asset_root), JWorld(asset_root=asset_root)
    assert sorted(a.chunks) == sorted(b.chunks) == list(range(1, 9))
    for cid in range(1, 9):
        np.testing.assert_array_equal(a.chunks[cid].pointers, b.chunks[cid].pointers)
        np.testing.assert_array_equal(a.chunks[cid].values, b.chunks[cid].values)
        assert int(a.chunks[cid].top_mip) == int(b.chunks[cid].top_mip)
    assert a.asset_root == asset_root


def test_default_asset_root_reads_the_environment(asset_root):
    """``DEFAULT_ASSET_ROOT`` comes from ``OT_ASSET_ROOT`` when the module
    is imported, as JAX's does."""
    import subprocess
    import sys

    code = ("from octree_tracer_tpu_torch.world.world import DEFAULT_ASSET_ROOT, World; "
            "print(DEFAULT_ASSET_ROOT, len(World().chunks))")
    env = dict(os.environ, OT_ASSET_ROOT=asset_root)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [asset_root, "8"]


def test_no_asset_root_reads_nothing_outside_the_repository(tmp_path):
    """Without ``OT_ASSET_ROOT`` there is no default asset root: ``World()``,
    a structure load and ``bench`` with no ``--scene`` raise
    FileNotFoundError naming ``OT_ASSET_ROOT``, and open no file on the
    way (an audit hook records every open after the imports)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import json, sys
from octree_tracer_tpu_torch import io, kernels, state
from octree_tracer_tpu_torch.app import cli, headless
from octree_tracer_tpu_torch.gen import structures
from octree_tracer_tpu_torch.render import camera, tracer
from octree_tracer_tpu_torch.world import world
opened = []  # the modules above are imported first: their files are read
sys.addaudithook(lambda ev, a: opened.append(str(a[0])) if ev == "open" else None)
errors = []
for call in (world.World, lambda: structures.load_structure_file("tree"),
             lambda: cli.main(["bench", "--device", "cpu"])):
    try:
        call()
    except FileNotFoundError as e:
        errors.append(str(e))
w = world.World(load_blocks=False)
print(json.dumps([world.DEFAULT_ASSET_ROOT, w.asset_root, errors, opened]))
"""
    env = {k: v for k, v in os.environ.items() if k != "OT_ASSET_ROOT"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert out.returncode == 0, out.stderr
    default, kept, errors, opened = json.loads(out.stdout.splitlines()[-1])
    assert default is None and kept is None
    assert len(errors) == 3 and all("OT_ASSET_ROOT" in e for e in errors)
    assert opened == []


@pytest.mark.parametrize("seed", [0, 1])
def test_stamp_leaves_equals_put_in_block_loop(seed):
    """``native.stamp_leaves`` leaves the arrays a ``put_in_block`` loop in
    the same order leaves, and JAX's binding of the same insert does too."""
    rng = np.random.default_rng(seed)
    depth = 5
    base = scenes.chunk_from_words(scenes.random_scene(depth, 200, seed))
    pos = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    ptrs = voxel.CHUNK_OFFSET + rng.integers(1, 9, 300).astype(np.uint32)
    vals = np.zeros(300, np.uint32)
    loop = CpuOctree.from_arrays(base.pointers.copy(), base.values.copy())
    for i in range(300):
        loop.put_in_block(pos[i], int(ptrs[i] - voxel.CHUNK_OFFSET), depth)
    got = native.stamp_leaves(base.pointers, base.values, pos, ptrs, vals, depth)
    np.testing.assert_array_equal(got[0], loop.pointers)
    np.testing.assert_array_equal(got[1], loop.values)
    want = jnative.stamp_leaves(base.pointers, base.values, pos, ptrs, vals, depth)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        native.stamp_leaves(base.pointers, base.values, pos, ptrs[:-1], vals, depth)
