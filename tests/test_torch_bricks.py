"""Brick maps (``render/bricks.py``, kernel K10's plain version) and K1's
brick DDA (``trace_plain(bricks=...)``, the plain version of K1's brick
mode) against the JAX package on the CPU.

The brick tables are equal array for array: the port's ``build_bricks_np`` and
``build_bricks`` (on the CPU ``build_bricks_plain``) against JAX's
``build_bricks_np`` and ``build_bricks``, on a hand tree, random trees, the
malformed pools and a pool with holes. The brick trace equals JAX's
``trace(bricks=...)`` on every field (hit_pos within the repository's 1e-5:
JAX's CPU build contracts the position update differently) and every
visit slot, counted and flagged, and equals the port's own traversal
without bricks on every field. The frame is held to JAX's staged frame by
the u8 rule of ``test_torch_render.py`` and by the two LOD invariants of
the visits. Scenes stay at 12 levels or fewer (JAX's CPU ``exp2`` is
inexact below 2^-12).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu.render import bricks as jbricks
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.core import CpuOctree, Octree
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET, pack_rgb
from octree_tracer_tpu_torch.render import bricks
from octree_tracer_tpu_torch.render import tracer as ttracer

RES = 64
CAM = (np.array([0.2, 0.3, -2.4], np.float32), np.array([-0.1, -0.15, 1.0], np.float32))
INSIDE = (np.array([-0.35, 0.55, -0.6], np.float32), np.array([0.3, -0.5, 1.0], np.float32))
EXACT = ("hit", "forced", "index", "steps", "depth", "normal", "word")


def _tree(depth, voxels, seed, side_depth=None):
    """A port CpuOctree of ``voxels`` random cells at ``depth``, as
    tests/test_bricks.py builds its fuzz trees."""
    rng = np.random.default_rng(seed)
    t = CpuOctree(0)
    side = 1 << (side_depth or depth)
    for c in rng.integers(0, side, (voxels, 3)):
        p = c.astype(np.float32) / side * 2 - 1
        t.put_in_voxel(p, int(rng.integers(1, 1 << 24)), depth)
    return t.to_words()


def _hand_tree():
    t = CpuOctree(0)
    t.put_in_voxel([0.9, 0.9, 0.9], pack_rgb(1, 2, 3), 3)
    t.put_in_voxel([-0.9, -0.9, -0.9], pack_rgb(4, 5, 6), 1)  # a coarse leaf
    return t.to_words()


def _holes():
    """A pool with free-list holes: the port's Octree subdivided to depth 4,
    then two interior nodes collapsed (``Octree.unsubdivide``), their child
    groups zeroed as free-list holes are (tests/test_bricks.py:160)."""
    rng = np.random.default_rng(5)

    def colours():
        return np.where(rng.random(8) < 0.4, 0, rng.integers(1, 1 << 24, 8)).astype(np.uint32)

    tree = Octree(colours())
    for depth in (2, 3, 4):
        for node in range(len(tree)):
            if tree.get_node(node) >= VOXEL_OFFSET and rng.random() < 0.5:
                tree.subdivide(node, colours(), depth)
    inner = [i for i in range(8, len(tree)) if tree.get_node(i) < VOXEL_OFFSET]
    for node in inner[:2]:
        tree.unsubdivide(node)
    words = tree.nodes.copy()
    freed = tree.drain_freed()
    for g in freed:
        words[g:g + 8] = 0
    return words, freed


POOLS = {
    "hand": _hand_tree,
    "holes": lambda: _holes()[0],
    "random3": lambda: _tree(3, 80, 23),
    "random5": lambda: _tree(5, 400, 23),
    "random6": lambda: scenes.random_scene(6, 900, 4),
    "deep_shell7": lambda: scenes.deep_shell(7),
    **{f"malformed_{k}": (lambda k=k: scenes.malformed_pools()[k])
       for k in scenes.malformed_pools()},
}


@functools.lru_cache(maxsize=None)
def _pool(name):
    return POOLS[name]()


@pytest.mark.parametrize("name", sorted(POOLS))
def test_build_bricks_equals_jax(name):
    words = _pool(name)
    dec_j, br_j = jbricks.build_bricks_np(words)
    dec_n, br_n = bricks.build_bricks_np(words)
    dec_t, br_t = bricks.build_bricks(state.u32_to_device(words, "cpu"))
    dec_jd, br_jd = jbricks.build_bricks(jnp.asarray(words))
    for dec, br in ((dec_n, br_n), (state.to_numpy_u32(dec_t), state.to_numpy_u32(br_t)),
                    (np.asarray(dec_jd), np.asarray(br_jd))):
        np.testing.assert_array_equal(dec, dec_j)
        np.testing.assert_array_equal(br, br_j)
    assert br_t.dtype == torch.int32 and tuple(br_t.shape) == (words.shape[0], 8)
    np.testing.assert_array_equal(dec_n >> np.uint32(4), words >> np.uint32(4))
    if name in ("hand", "random5", "deep_shell7", "malformed_past_end16"):
        assert (dec_n & 1).any()


def test_hand_tree_brick_row():
    """tests/test_bricks.py:38's tree: the (+,+,+) root child is a brick
    root whose one fine bit (63) and coarse-leaf mask match the tree."""
    words = _hand_tree()
    dec, br = bricks.build_bricks_np(words)
    row = br[7]
    assert dec[7] & 1 == 1 and row[0] & 1 == 1 and row[3] == words[7] >> 4
    assert (row[2] >> 31) & 1 == 1
    assert bin(int(row[1])).count("1") + bin(int(row[2])).count("1") == 1
    assert [(int(row[0]) >> (c + 1)) & 1 for c in range(8)] == [1] * 7 + [0]
    assert dec[0] & 1 == 0


def test_holes_not_decorated():
    words, freed = _holes()
    dec, br = bricks.build_bricks_np(words)
    dec_t, br_t = bricks.build_bricks(state.u32_to_device(words, "cpu"))
    dec_j, br_j = jbricks.build_bricks_np(words)
    np.testing.assert_array_equal(dec, dec_j)
    np.testing.assert_array_equal(state.to_numpy_u32(br_t), br_j)
    for g in freed:
        assert not (dec[g:g + 8] & 1).any() and not br[g:g + 8].any()


def test_k10_bytes_counts_the_pool_once():
    """K10's bound: 40 bytes a slot, the word in and the decorated word and
    the 32-byte row out. The children and grandchildren rows it reads are
    rows of the same pool, read once with it, and add nothing."""
    words = _hand_tree()
    n = words.shape[0]
    assert n == 24
    assert bricks.k10_bytes(state.u32_to_device(words, "cpu")) == 40 * n
    leaves = np.full(16, VOXEL_OFFSET << 4, np.uint32)
    assert bricks.k10_bytes(state.u32_to_device(leaves, "cpu")) == 40 * 16


def _rays(pos_look=CAM, res=RES):
    _, ci = camera_matrices(*pos_look, 70.0, res, res)
    o, d = generate_rays(ci, res, res)
    d = np.asarray(d).reshape(-1, 3)
    return np.broadcast_to(np.asarray(o), d.shape).copy(), d


def _fuzz_rays(seed, n=512, span=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port(words, o, d, **kw):
    dec, br = bricks.build_bricks(state.u32_to_device(words, "cpu"))
    res = ttracer.trace(dec, torch.from_numpy(o), torch.from_numpy(d), bricks=br, **kw)
    return ttracer.to_numpy(res)


def _jax(words, o, d, **kw):
    dec, br = jbricks.build_bricks(jnp.asarray(words))
    res, visits = jtracer.trace(dec, jnp.asarray(o), jnp.asarray(d), bricks=br, **kw)
    return ttracer.to_numpy(res), (None if visits is None else np.asarray(visits))


def _assert_exact(a, b):
    for f in EXACT:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert np.abs(a["hit_pos"] - b["hit_pos"]).max() <= 1e-5


def _assert_same(a, b):
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


TRACE_CASES = [  # (strict, parent_restart, brick_k, visit_flags)
    (True, True, 4, False), (True, True, 1, True), (True, False, 7, False),
    (False, True, 4, True), (False, False, 1, False), (True, False, 4, True),
]


@pytest.mark.parametrize("strict,restart,k,flags", TRACE_CASES)
def test_brick_trace_equals_jax(strict, restart, k, flags):
    """64x64 rays from inside the root cube (JAX's CPU build rounds entry
    points on the cube's face an ulp otherwise, which moves visit
    magnitudes; see test_torch_visits.py) on a depth-6 random tree: every
    field, and every visit slot counted or flagged, equal to JAX's; every
    field equal to the port's traversal without bricks."""
    words = _pool("random6")
    o, d = _rays(INSIDE)
    kw = dict(strict_descent=strict, parent_restart=restart, brick_k=k)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, o, d, visits=visits, visit_flags=flags, **kw)
    b, vb = _jax(words, o, d, with_visits=True, visit_flags=flags, **kw)
    _assert_exact(a, b)
    np.testing.assert_array_equal(visits.numpy(), vb)
    plain = ttracer.to_numpy(ttracer.trace(
        state.u32_to_device(words, "cpu"), torch.from_numpy(o), torch.from_numpy(d),
        strict_descent=strict, parent_restart=restart))
    _assert_same(a, plain)
    assert a["hit"].sum() > 100 and visits.numpy().any()


@pytest.mark.parametrize("k", [1, 4, 7])
def test_brick_k_results_equal(k):
    """Results are the same for every brick_k (the bench camera, outside
    the cube, the deep shell): equal to the traversal without bricks."""
    words = _pool("deep_shell7")
    o, d = _rays()
    a = _port(words, o, d, brick_k=k)
    b = ttracer.to_numpy(ttracer.trace(state.u32_to_device(words, "cpu"),
                                       torch.from_numpy(o), torch.from_numpy(d)))
    _assert_same(a, b)
    assert a["hit"].sum() > 200


def test_brick_errors():
    """JAX's exclusions raise as in JAX; a table of the wrong shape is
    refused."""
    words = _pool("random5")
    w = state.u32_to_device(words, "cpu")
    dec, br = bricks.build_bricks(w)
    o, d = (torch.from_numpy(x) for x in _fuzz_rays(0, 8))
    table = ttracer.build_warp_table(w, 2)
    with pytest.raises(ValueError, match="bricks exclude warp_table"):
        ttracer.trace(dec, o, d, bricks=br, warp_table=table)
    with pytest.raises(ValueError, match="bricks exclude warp_table"):
        ttracer.trace_plain(dec, o, d, bricks=br, warp_table=table)
    with pytest.raises(ValueError, match="bricks exclude warp_table"):
        ttracer.render_frame(dec, o[0], d.reshape(2, 4, 3), bricks=br, warp_table=table)
    res = ttracer.trace(dec, o, d, bricks=br)
    with pytest.raises(ValueError, match="bricks exclude warp_table"):
        ttracer.trace_shadow(dec, res, bricks=br, warp_table=table, image_width=0)
    with pytest.raises(ValueError, match="shape"):
        ttracer.trace(dec, o, d, bricks=br[:-1])
    with pytest.raises(TypeError):
        ttracer.trace(dec, o, d, bricks=br.long())
    with pytest.raises(TypeError):
        bricks.build_bricks(w.long())
    with pytest.raises(ValueError, match="empty"):
        bricks.build_bricks(w[:0])
