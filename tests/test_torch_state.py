"""state.py: u32 pool and table words carried as int32 tensors of the same
bits, including words >= 2^31 (every leaf word is)."""

import numpy as np
import pytest
import torch

from octree_tracer_tpu.core import CpuOctree
from octree_tracer_tpu_torch import state

EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1], dtype=np.uint32)


@pytest.fixture
def words():
    rng = np.random.default_rng(11)
    return np.concatenate([EDGES, rng.integers(0, 2**32, 1000, dtype=np.uint32)])


def test_round_trip_keeps_bits(words):
    t = state.u32_to_device(words, "cpu")
    assert t.dtype == torch.int32 and t.is_contiguous()
    np.testing.assert_array_equal(state.to_numpy_u32(t), words)


def test_widen_gives_u32_values(words):
    wide = state.widen_u32(state.u32_to_device(words, "cpu"))
    assert wide.dtype == torch.int64
    np.testing.assert_array_equal(wide.numpy(), words.astype(np.int64))
    assert int((wide >> 4).max()) == (2**32 - 1) >> 4


def test_narrow_inverts_widen(words):
    t = state.u32_to_device(words, "cpu")
    assert torch.equal(state.narrow_u32(state.widen_u32(t)), t)


def test_pool_from_cpu_octree():
    tree = CpuOctree(0)
    tree.put_in_voxel(np.array([0.5, -0.5, 0.25], np.float32), 0xABCDEF, 3)
    words = tree.to_words()
    assert words.max() >= 2**31
    np.testing.assert_array_equal(
        state.to_numpy_u32(state.u32_to_device(words, "cpu")), words)


@pytest.mark.parametrize("n,ok", [(8**3, True), (2 * 8**3, True), (1, True),
                                  (10, False), (3 * 8**2, False)])
def test_table_to_device_checks_length(n, ok):
    table = np.arange(n, dtype=np.uint32) | np.uint32(1 << 31)
    if ok:
        np.testing.assert_array_equal(
            state.to_numpy_u32(state.table_to_device(table, "cpu")), table)
    else:
        with pytest.raises(ValueError):
            state.table_to_device(table, "cpu")
