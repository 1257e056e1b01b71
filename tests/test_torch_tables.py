"""Tables: the port's warp table, occupancy, skip field and combined
warp+skip table (plain version of kernel K2 plus the NumPy cube
compositions) equal the JAX package's exactly, at L = 3 and 4."""

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
