"""The helpers that give K1's passes their bounds (``tracer.touched_rows``,
``k1_bytes``, ``k1_shadow_bytes``, ``slot_depths``, ``longest_trips``) and
the pool that times K1's trip on L2-resident rows (``scenes.chain_pool``),
on the CPU with K1's plain version."""

import numpy as np
import pytest
import torch

from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.probes.trace_steps import marks_by_depth
from octree_tracer_tpu_torch.render import camera
from octree_tracer_tpu_torch.render import tracer as ttracer

CAM = (np.array([0.2, 0.3, -2.4], np.float32), np.array([-0.1, -0.15, 1.0], np.float32))
RES = 32


def _rays(res=RES):
    _, ci = camera.camera_matrices(*CAM, 70.0, res, res)
    o, d = camera.generate_rays(ci, res, res)
    d = torch.from_numpy(np.asarray(d).reshape(-1, 3).copy())
    return torch.from_numpy(np.asarray(o)).expand(d.shape[0], 3), d


def test_slot_depths_of_a_built_tree():
    """Every slot of a tree built level by level lies at the depth of its
    group's node; a slot's children lie one level below it."""
    words = scenes.deep_shell(5)
    depth = ttracer.slot_depths(words)
    assert (depth >= 0).all() and depth[:8].tolist() == [0] * 8
    payload = (words >> np.uint32(4)).astype(np.int64)
    interior = np.nonzero(payload < ttracer.VOXEL_OFFSET)[0]
    assert (depth[payload[interior]] == depth[interior] + 1).all()
    assert depth.max() == 4


@pytest.mark.parametrize("pool,reached", [("self_cycle", 8), ("past_end16", 8),
                                          ("ragged21", 21)])
def test_slot_depths_of_malformed_pools(pool, reached):
    """A cycle is followed once; groups past the pool's end, and pointers
    off a group's start, are not followed."""
    words = scenes.malformed_pools()[pool]
    depth = ttracer.slot_depths(words)
    assert int((depth >= 0).sum()) == reached
    assert depth[:8].tolist() == [0] * 8


@pytest.mark.parametrize("table", [False, True])
def test_root_form_marks_every_descent_at_depth_0(table):
    """The root form re-descends after every boundary step: without a table
    every descent marks one root-group slot, so the marks at depth 0 are the
    descents, one more than the steps of every entered ray (the step that
    forces a hit starts none); every mark lies on a slot a descent reaches."""
    words = scenes.deep_shell(6)
    w = state.u32_to_device(words, "cpu")
    o, d = _rays()
    t = ttracer.build_warp_table(w, 3) if table else None
    v = torch.zeros(w.shape[0], dtype=torch.int32)
    res = ttracer.trace(w, o, d, visits=v, parent_restart=False, warp_table=t)
    by_depth = marks_by_depth(v, ttracer.slot_depths(words))
    assert sum(by_depth) == int(v.sum())
    entered = res.depth > 0
    descents = int((res.steps[entered] + 1 - res.forced[entered].int()).sum())
    if table:
        assert by_depth[0] < descents
    else:
        assert by_depth[0] == descents


def test_longest_trips_is_the_longest_ray():
    """The binary search over K1's trip cap finds the trips of the longest
    ray, which a scan of every cap confirms: under one trip fewer some ray
    stays unresolved, under that many none."""
    w = state.u32_to_device(scenes.deep_shell(5), "cpu")
    o, d = _rays(16)
    full = ttracer.trace(w, o, d, parent_restart=False)
    live = full.depth > 0

    def capped(t):
        return ttracer.trace(w, o, d, parent_restart=False, max_iters=t)

    n = ttracer.longest_trips(capped, live, ttracer._max_iters(ttracer.MAX_STEPS, None))
    scan = next(t for t in range(4000) if not bool(((capped(t).depth == 0) & live).any()))
    assert n == scan > 10
    assert bool(((capped(n - 1).depth == 0) & live).any())


def test_k1_bytes_counts_rows_rays_and_marked_slots():
    """A counting pass's bytes: its touched rows, 54 bytes a ray and the
    origin, and 8 bytes a marked slot; the shadow mode's: rows, 2 bytes a
    ray, 12 a traced ray and 8 a marked slot."""
    w = state.u32_to_device(scenes.deep_shell(5), "cpu")
    o, d = _rays()
    v = torch.zeros(w.shape[0], dtype=torch.int32)
    ttracer.trace(w, o, d, visits=v)
    rows = ttracer.touched_rows(v)
    assert rows == len({int(s) >> 3 for s in torch.nonzero(v).flatten()})
    marked = int((v > 0).sum())
    n = d.shape[0]
    assert ttracer.k1_bytes(rows, n) == rows * 32 + 12 + 54 * n
    assert ttracer.k1_bytes(rows, n, marked) - ttracer.k1_bytes(rows, n) == 8 * marked
    assert ttracer.k1_shadow_bytes(rows, n, 100, marked) == rows * 32 + 2 * n + 1200 + 8 * marked


@pytest.mark.parametrize("trips", [0, 5, 40])
def test_chain_pool_is_one_chain_of_rows(trips):
    """Every word of the chain points at the next group of one cycle through
    all groups: one ray capped at T trips reads T rows, no row twice while
    T <= groups, and stays unresolved."""
    groups = 64
    words = scenes.chain_pool(groups, seed=3)
    assert words.shape == (8 * groups,)
    nxt = (words[::8] >> np.uint32(4)) // 8
    assert (words.reshape(groups, 8) == words[::8, None]).all()
    seen, g = set(), 0
    for _ in range(groups):
        seen.add(g)
        g = int(nxt[g])
    assert len(seen) == groups and g == 0
    w = state.u32_to_device(words, "cpu")
    v = torch.zeros(w.shape[0], dtype=torch.int32)
    res = ttracer.trace(w, torch.tensor([[0.1, 0.2, 0.3]]), torch.tensor([[0.3, 0.5, 0.8]]),
                        visits=v, max_iters=trips)
    assert not bool(res.hit[0]) and int(res.depth[0]) == 0
    assert int(v.sum()) == trips == ttracer.touched_rows(v)
    assert sorted(np.unique(ttracer.slot_depths(words) // 1)) == list(range(groups))
    with pytest.raises(ValueError):
        scenes.chain_pool(1)
