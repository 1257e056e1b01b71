"""Tables: the port's warp table, occupancy, skip field and combined
warp+skip table (plain version of kernel K2 plus the NumPy cube
compositions) equal the JAX package's exactly, at L = 3 and 4, and at L 1-4
on pools whose pointers run past their end (JAX's clamped row gather). The
descent's float comparison picks the cell coordinate's bit, which K2's
integer descent uses; ``k2_bytes`` counts what K2 must move."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.render import skip as tskip
from octree_tracer_tpu_torch.render import tracer as ttracer

SCENES = {
    "shell5": lambda: scenes.deep_shell(5),
    "random5": lambda: scenes.random_scene(5, 300, 1),
    "random6": lambda: scenes.random_scene(6, 2000, 2),
}

JAX = {
    "warp": lambda w, lv: jtracer.build_warp_table(jnp.asarray(w), lv),
    "occupancy": lambda w, lv: jskip.occupancy_from_pool(jnp.asarray(w), lv),
    "skip": lambda w, lv: jskip.build_skip_field(jnp.asarray(w), lv),
    "combined": lambda w, lv: jskip.build_warp_skip_table(jnp.asarray(w), lv),
}
PORT = {
    "warp": ttracer.build_warp_table,
    "occupancy": tskip.occupancy_from_pool,
    "skip": tskip.build_skip_field,
    "combined": tskip.build_warp_skip_table,
}


@functools.lru_cache(maxsize=None)
def _words(scene):
    return SCENES[scene]()


@pytest.mark.parametrize("levels", [3, 4])
@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("table", sorted(JAX))
def test_table_equals_jax(table, scene, levels):
    words = _words(scene)
    expect = np.asarray(JAX[table](words, levels))
    got = PORT[table](state.u32_to_device(words, "cpu"), levels)
    got = got.numpy() if table == "occupancy" else state.to_numpy_u32(got)
    assert got.shape == expect.shape
    np.testing.assert_array_equal(got, expect)


def test_warp_occupancy_is_one_descent():
    """K2's pair: the warp words are build_warp_table's and the occupancy
    is occupancy_from_pool's, from the same call."""
    words = state.u32_to_device(_words("random5"), "cpu")
    warp, occ = ttracer.warp_occupancy(words, 3)
    assert warp.dtype == torch.int32 and occ.dtype == torch.bool
    np.testing.assert_array_equal(warp.numpy(), ttracer.build_warp_table(words, 3).numpy())
    np.testing.assert_array_equal(occ.numpy(), tskip.occupancy_from_pool(words, 3).numpy())
    assert ttracer.warp_table_levels(warp) == 3
    table = tskip.build_warp_skip_table(words, 3)
    assert ttracer.warp_table_levels(table) == 3
    assert ttracer.warp_table_combined(table)
    assert not ttracer.warp_table_combined(warp)


MALFORMED = scenes.malformed_pools()


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("pool", sorted(MALFORMED))
def test_malformed_pool_tables_equal_jax(pool, levels):
    """Pointers past the pool's end read as JAX's clamped row gather reads
    them: K2's plain version, build_warp_table and occupancy_from_pool
    equal JAX's exactly."""
    words = MALFORMED[pool]
    expect_warp = np.asarray(jtracer.build_warp_table(jnp.asarray(words), levels))
    expect_occ = np.asarray(jskip.occupancy_from_pool(jnp.asarray(words), levels))
    w = state.u32_to_device(words, "cpu")
    warp, occ = ttracer.warp_occupancy_plain(w, levels)
    np.testing.assert_array_equal(state.to_numpy_u32(warp), expect_warp)
    np.testing.assert_array_equal(occ.numpy(), expect_occ)
    np.testing.assert_array_equal(state.to_numpy_u32(ttracer.build_warp_table(w, levels)),
                                  expect_warp)
    np.testing.assert_array_equal(tskip.occupancy_from_pool(w, levels).numpy(), expect_occ)


def test_past_end16_reads_the_last_row():
    """The 16-word pool whose root points every child at group 16: every
    cell resumes at (16, depth 1), and at L2 only the cells of child 7 of
    row 1 (the filled leaf) are occupied."""
    w = state.u32_to_device(MALFORMED["past_end16"], "cpu")
    warp, occ = ttracer.warp_occupancy_plain(w, 2)
    assert (state.to_numpy_u32(warp) == (16 << 5) | 1).all()
    assert int(occ.sum()) == 8


def _bit_pools():
    """Random pools, and one whose every child points back at the root
    group, so that every descent runs all L levels."""
    loop = np.full(8, 0, dtype=np.uint32)  # payload 0: the root group
    return [loop, scenes.random_scene(5, 300, 1), scenes.random_scene(7, 3000, 4)]


@pytest.mark.parametrize("levels", range(10))
def test_descent_child_is_the_coordinate_bit(levels):
    """K2's integer descent: at every trip the child JAX's f32 comparison
    ``centre > node_pos`` picks is bit L-1-depth of the cell's coordinates
    (a cell centre is an odd multiple of 2^-L, a node centre at depth d < L
    a multiple of 2^-d, both exact in f32), whether the descent still moves
    or has stopped. Every cell for L <= 7, a strided sample at 8 and 9."""
    side = 1 << levels
    cells = None if levels <= 7 else torch.arange(0, side ** 3, 8191, dtype=torch.int64)
    c = torch.arange(side ** 3, dtype=torch.int64) if cells is None else cells
    xyz = torch.stack([c >> (2 * levels), (c >> levels) & (side - 1), c & (side - 1)], 1)
    trips = []

    def check(it, child, depth, read):
        b = (levels - 1 - depth)[:, None]
        bits = (xyz >> b) & 1
        assert torch.equal(child, bits[:, 0] * 4 + bits[:, 1] * 2 + bits[:, 2])
        trips.append(int((depth == it).sum()))

    for i, words in enumerate(_bit_pools()):
        trips.clear()
        ttracer._k2_descent(state.u32_to_device(words, "cpu"), levels, cells, check)
        assert len(trips) == levels
        if i == 0:  # the looping pool moves every cell on every trip
            assert trips == [c.numel()] * levels


def test_k2_bytes_counts_read_sectors():
    """5 bytes a cell, and each 32-byte pool row the descents read, once;
    words of the last row past the pool's end read no memory."""
    empty = np.uint32(ttracer.VOXEL_OFFSET << 4)
    filled = np.uint32((ttracer.VOXEL_OFFSET + 0x123456) << 4)
    # Root child 0 -> group 8 of filled leaves; the rest empty leaves.
    tiny = np.array([8 << 4] + [empty] * 7 + [filled] * 8, dtype=np.uint32)
    w = state.u32_to_device(tiny, "cpu")
    assert ttracer.k2_bytes(w, 0) == 5
    assert ttracer.k2_bytes(w, 1) == 8 * 5 + 32
    assert ttracer.k2_bytes(w, 2) == 64 * 5 + 2 * 32
    assert ttracer.k2_bytes(w, 3) == 512 * 5 + 2 * 32
    # past_end16 reads rows 0 and 1; ragged21 rows 0, 1 and 2 (its root's
    # pointers to groups 16 and 40 both read row 2, 5 words in memory).
    assert ttracer.k2_bytes(state.u32_to_device(MALFORMED["past_end16"], "cpu"), 2) == 384
    assert ttracer.k2_bytes(state.u32_to_device(MALFORMED["ragged21"], "cpu"), 2) == 416


@pytest.mark.parametrize("call", ["warp_occupancy", "trace"])
def test_empty_pool_raises(call):
    words = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="empty"):
        if call == "warp_occupancy":
            ttracer.warp_occupancy(words, 2)
        else:
            ttracer.trace(words, torch.zeros(4, 3), torch.ones(4, 3))
