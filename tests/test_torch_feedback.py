"""LOD feedback: the port's ``select_candidates_packed`` (on the CPU, the
plain version of kernel K5), ``propagate_visits`` (K6) and ``apply_patches``
against the JAX package's ``adaptive/feedback.py`` on the same NumPy inputs.

Selection and closure are integer programs, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu.adaptive import feedback as jfeedback
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.adaptive import feedback
from octree_tracer_tpu_torch.core.octree import Octree
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET


def _pool(seed, pad=0):
    """A random tree's words with some zeroed groups (holes) and ``pad``
    zero words past its end, and visits with many zeros, ones, and counts
    past the 15 clamp."""
    rng = np.random.default_rng(seed)
    words = scenes.random_scene(5, 400, seed).copy()
    for g in rng.choice(words.shape[0] // 8, 3, replace=False):
        words[8 * g: 8 * g + 8] = 0
    words = np.concatenate([words, np.zeros(pad, np.uint32)])
    visits = rng.choice([0, 0, 0, 1, 3, 4, 9, 15, 40], words.shape[0]).astype(np.int32)
    return words, visits


def _both(words, visits, node_len, sub_cap, unsub_cap, offset):
    got = feedback.select_candidates_packed(
        state.u32_to_device(words, "cpu"), torch.from_numpy(visits), node_len,
        sub_cap=sub_cap, unsub_cap=unsub_cap, offset=offset)
    want = jfeedback.select_candidates_packed(
        jnp.asarray(words), jnp.asarray(visits), jnp.int32(node_len),
        sub_cap=sub_cap, unsub_cap=unsub_cap, offset=jnp.int32(offset))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("caps", [(4096, 4096), (37, 11), (0, 5)])
@pytest.mark.parametrize("offset", [0, 1234, -5])
@pytest.mark.parametrize("node_len", ["all", "part"])
def test_select_candidates_packed_equals_jax(caps, offset, node_len):
    words, visits = _pool(1, pad=13)
    n_live = words.shape[0] - 13
    nl = n_live if node_len == "all" else n_live // 3
    got, want = _both(words, visits, nl, *caps, offset)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (2 + sum(caps),)
    assert got[0] > 0 and got[1] > 0
    if caps == (37, 11):  # both lists overflow: full lists, uncapped counts
        assert got[0] > 37 and got[1] > 11
        assert (got[2:] >= 0).all()


def test_select_candidates_rules_and_rotation():
    """The rules on a hand-built pool, and the rotated order: the list
    starts at the first candidate at or after ``offset`` and wraps."""
    words = np.zeros(24, np.uint32)
    leaf = lambda rgb: (VOXEL_OFFSET + rgb) << 4  # noqa: E731
    words[0:8] = [leaf(5), leaf(5), leaf(0), 8 << 4, leaf(7), 16 << 4, leaf(5), leaf(5)]
    words[8:16] = leaf(1)
    visits = np.zeros(24, np.int32)
    visits[[0, 1, 2, 4, 6, 7]] = [4, 3, 9, 40, 15, 4]
    visits[5] = 2  # a visited interior is kept
    got = feedback.select_candidates_packed(
        state.u32_to_device(words, "cpu"), torch.from_numpy(visits), 16,
        sub_cap=8, unsub_cap=8, offset=5).numpy()
    # filled leaves with a count >= 4: 0, 4, 6, 7 (2 is empty, 1 has 3);
    # interiors with no visit: 3 (5 was visited); slots >= 16 are invalid.
    assert list(got[:2]) == [4, 1]
    assert list(got[2:10]) == [6, 7, 0, 4, -1, -1, -1, -1]
    assert list(got[10:]) == [3] + [-1] * 7
    sub_idx, sub_n, unsub_idx, unsub_n = feedback.select_candidates(
        state.u32_to_device(words, "cpu"), torch.from_numpy(visits), 16,
        sub_cap=8, unsub_cap=8, offset=5)
    assert int(sub_n) == 4 and int(unsub_n) == 1
    assert list(sub_idx.numpy()[:4]) == [6, 7, 0, 4]
    assert list(unsub_idx.numpy()[:1]) == [3]


@pytest.mark.parametrize("seed", [2, 3])
def test_propagate_visits_equals_jax(seed):
    words, _ = _pool(seed, pad=5)
    rng = np.random.default_rng(seed)
    visits = np.where(rng.random(words.shape[0]) < 0.05, 1, 0).astype(np.int32)
    for passes in (0, 1, 3, 8):
        got = feedback.propagate_visits(state.u32_to_device(words, "cpu"),
                                        torch.from_numpy(visits), passes).numpy()
        want = np.asarray(jfeedback.propagate_visits(
            jnp.asarray(words), jnp.asarray(visits), passes=passes))
        np.testing.assert_array_equal(got, want)
    assert (got >= visits).all() and (got != visits).any()


def _chain(depth):
    """An Octree split along one path down to ``depth``: the deepest leaf
    is visited, nothing else."""
    t = Octree(np.full(8, 0x808080, np.uint32))
    node = 0
    for d in range(2, depth + 1):
        t.subdivide(node, np.full(8, 0x808080, np.uint32), d)
        node = t.get_node(node)
    visits = np.zeros(len(t), np.int32)
    visits[node] = 1
    return t, visits


def test_propagate_visits_pass_count_from_tree_depth():
    """The JAX Session caps the closure at min(24, octree_depth + 2) passes,
    14 under the default settings. On a tree deeper than that the capped
    closure leaves shallow ancestors of a visited leaf at 0, which the
    selection reads as collapse candidates. The port's Session runs
    ``Octree.max_depth + 1`` passes, which closes the whole path."""
    t, visits = _chain(20)
    assert t.max_depth == 20
    words = t.nodes.copy()
    ancestors = np.flatnonzero((words >> 4) < VOXEL_OFFSET)
    assert ancestors.size == 19
    capped = np.asarray(jfeedback.propagate_visits(
        jnp.asarray(words), jnp.asarray(visits), passes=14))
    assert (capped[ancestors] == 0).sum() == 5
    got = feedback.propagate_visits(state.u32_to_device(words, "cpu"),
                                    torch.from_numpy(visits), t.max_depth + 1).numpy()
    assert (got[ancestors] == 1).all()
    want = np.asarray(jfeedback.propagate_visits(
        jnp.asarray(words), jnp.asarray(visits), passes=t.max_depth + 1))
    np.testing.assert_array_equal(got, want)


def test_apply_patches_equals_jax():
    """-1 entries are dropped. JAX's ``.at[idx].set(mode="drop")`` wraps a
    negative index to the last slot before it drops out-of-range ones, so
    the JAX Session's -1 padding (``pad_patches``) writes 0 into the pool's
    last slot; the comparison gives JAX only the real patches."""
    words, _ = _pool(4)
    rng = np.random.default_rng(4)
    idx = rng.choice(words.shape[0] - 1, 40, replace=False).astype(np.int32)
    idx[::7] = -1
    vals = rng.integers(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32)
    dev = state.u32_to_device(words, "cpu")
    got = state.to_numpy_u32(feedback.apply_patches(dev, idx, vals))
    keep = idx >= 0
    want = np.asarray(jfeedback.apply_patches(
        jnp.asarray(words), jnp.asarray(idx[keep]), jnp.asarray(vals[keep])))
    np.testing.assert_array_equal(got, want)
    assert got[-1] == words[-1]
    wrapped = np.asarray(jfeedback.apply_patches(jnp.asarray(words), jnp.asarray(idx),
                                                 jnp.asarray(vals)))
    assert wrapped[-1] != words[-1]
    # the frame's snapshot is untouched
    np.testing.assert_array_equal(state.to_numpy_u32(dev), words)


@pytest.mark.parametrize("n", [1, 3, 4095, 4096, 4097, 3 * 4096 + 5])
@pytest.mark.parametrize("residue", [0, 1, 2, 3])
def test_select_candidates_edges_equal_jax(n, residue):
    """The shapes at K5's edges (4096-slot tiles, 16-byte loads): pools
    under one tile, of one tile and past it, of no multiple of 4; offsets
    of every residue mod 4, at n - 1 and beside a tile edge; caps of 0,
    caps the lists overflow and caps they fit in. The port equals JAX."""
    words, visits = zip(*(_pool(seed) for seed in (3, 4, 5)))
    words, visits = np.concatenate(words)[:n], np.concatenate(visits)[:n]
    offsets = {o for o in (residue, n - 1 - residue, 4096 + residue, n // 2 + residue)
               if 0 <= o < n}
    caps = [(0, 0), (5, 3), (n, n)]
    for k, offset in enumerate(sorted(offsets)):
        sub_cap, unsub_cap = caps[k % 3]
        got, want = _both(words, visits, n - n // 5, sub_cap, unsub_cap, offset)
        np.testing.assert_array_equal(got, want)


def test_select_bytes():
    """K5's bound counts 8 bytes a slot and the packed output once."""
    assert feedback.select_bytes(10, 0, 0) == 88
    assert feedback.select_bytes(7_900_000, 65536, 65536) == 8 * 7_900_000 + 4 * 131074
    words, visits = _pool(5)
    out = feedback.select_candidates_packed(
        state.u32_to_device(words, "cpu"), torch.from_numpy(visits), words.shape[0],
        sub_cap=9, unsub_cap=4)
    assert feedback.select_bytes(words.shape[0], 9, 4) == words.nbytes + visits.nbytes \
        + out.numel() * 4
