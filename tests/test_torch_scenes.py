"""scenes.py: ``build_leaves`` lays out the pool word for word as the JAX
package's ``native.build_leaves`` and ``CpuOctree.put_in_voxel`` do."""

import numpy as np
import pytest

from octree_tracer_tpu import native
from octree_tracer_tpu.core import CpuOctree
from octree_tracer_tpu.core.voxel import CHUNK_OFFSET
from octree_tracer_tpu_torch import scenes


@pytest.mark.parametrize("depth", [1, 2, 4, 6])
def test_shell_matches_native_build(depth):
    cells, rgb = scenes.shell_cells(depth)
    pos = (cells.astype(np.float32) + 0.5) / (1 << depth) * 2.0 - 1.0
    ptrs, vals = native.build_leaves(
        pos, np.full(cells.shape[0], CHUNK_OFFSET, np.uint32), rgb, depth)
    expect = CpuOctree.from_arrays(ptrs, vals).to_words()
    np.testing.assert_array_equal(scenes.deep_shell(depth), expect)


@pytest.mark.parametrize("depth,n,seed", [(2, 12, 0), (3, 40, 1), (5, 300, 2)])
def test_random_cells_match_put_in_voxel(depth, n, seed):
    """Random cells, repeats included (the last colour wins), inserted one by
    one through CpuOctree.put_in_voxel as tests/test_tracer.py builds trees."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 1 << depth, (n, 3))
    rgb = rng.integers(0, 1 << 24, n).astype(np.uint32)
    tree = CpuOctree(0)
    for c, col in zip(cells, rgb):
        tree.put_in_voxel(c.astype(np.float32) / (1 << depth) * 2 - 1, int(col), depth)
    np.testing.assert_array_equal(scenes.build_leaves(cells, rgb, depth),
                                  tree.to_words())


def test_random_scene_is_deterministic():
    a = scenes.random_scene(4, 50, 9)
    np.testing.assert_array_equal(a, scenes.random_scene(4, 50, 9))
    assert a.shape[0] % 8 == 0


def test_build_leaves_rejects_cells_outside_grid():
    with pytest.raises(ValueError):
        scenes.build_leaves(np.array([[0, 0, 4]]), np.array([1], np.uint32), 2)
