"""The adaptive streaming Session: the port's ``app.session.Session`` (on the
CPU, the plain versions of its six kernels) in lockstep with the JAX
package's Session, and the port's own invariants.

Both Sessions stream from one set of chunk arrays carried across by
``state.world_to_numpy``. The cameras are generic: from the default
``Character`` view JAX's own ``trace`` disagrees with the oracle on
knife-edge rays, and one flipped ray can flip an LOD decision.
"""

import numpy as np
import pytest
import torch

from octree_tracer_tpu.app.session import Session as JSession
from octree_tracer_tpu.core import CpuOctree as JCpuOctree
from octree_tracer_tpu.world.world import World as JWorld
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.app.session import Session
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET

RES = 32
POS = np.array([0.25, 0.35, -2.3], np.float32)
LOOK = np.array([-0.12, -0.17, 1.0], np.float32)


def _jax_world(chunks):
    world = JWorld(load_blocks=False)
    for cid, (ptrs, vals, top_mip) in chunks.items():
        world.chunks[cid] = JCpuOctree.from_arrays(ptrs, vals, top_mip=top_mip)
    return world


def _aim(s, look=LOOK):
    s.character.pos = POS.copy()
    s.character.look = np.asarray(look, np.float32).copy()
    s.settings.fov = 70.0


def _port_session(depth=6, use_native=None, **settings):
    s = Session(scenes.shell_world(depth), RES, RES, pool_capacity=65536,
                use_native=use_native, device="cpu")
    _aim(s)
    for k, v in settings.items():
        setattr(s.settings, k, v)
    return s


def assert_partition(octree):
    """Every allocated child group is reachable from the root or on the
    hole stack, never both (tests/test_session.py:334-360): a subdivision
    of a slot inside a freed group leaks a group and breaks it."""
    words = octree.nodes
    reachable, frontier = set(), [0]
    while frontier:
        base = frontier.pop()
        if base in reachable:
            continue
        reachable.add(base)
        for slot in range(base, base + 8):
            payload = int(words[slot]) >> 4
            if payload < VOXEL_OFFSET and payload != 0:
                frontier.append(payload)
    holes = set(octree.hole_stack)
    allocated = set(range(8, len(octree), 8))
    assert not (reachable & holes), "hole group still reachable"
    orphans = allocated - (reachable - {0}) - holes
    assert not orphans, f"leaked groups at {sorted(orphans)[:8]}"


def assert_pool_is_host(s):
    n = len(s.octree)
    pool = state.to_numpy_u32(s.device_words)
    np.testing.assert_array_equal(pool[:n], s.octree.nodes)
    assert not pool[n:].any()


CONFIGS = {
    "defaults": {},
    "sync_fb2_warp": dict(deferred_feedback=False, feedback_every=2, warp_pool_words=1),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_session_lockstep_equals_jax(config):
    """Images, per-step stats and pools equal at every step, through growth
    and, after a turn, collapses. ``sync_fb2_warp`` rides the combined
    warp+skip table from the first frame, so its counted frames take the
    visit closure and its patches the incremental table invalidation."""
    chunks = state.world_to_numpy(scenes.shell_world(6))
    a = Session(state.world_from_numpy(chunks), RES, RES, pool_capacity=65536,
                device="cpu")
    b = JSession(_jax_world(chunks), RES, RES, pool_capacity=65536)
    for s in (a, b):
        _aim(s)
        for k, v in CONFIGS[config].items():
            setattr(s.settings, k, v)
    totals = {"subdivided": 0, "collapsed": 0}
    for i in range(11):
        if i == 7:
            for s in (a, b):
                s.character.turn(900.0, 300.0, fov=70.0)
        img_a, res_a, st_a = a.step()
        img_b, _, st_b = b.step()
        np.testing.assert_array_equal(img_a.numpy(), np.asarray(img_b), err_msg=f"step {i}")
        assert st_a == st_b, f"step {i}: {st_a} vs {st_b}"
        np.testing.assert_array_equal(state.to_numpy_u32(a.device_words),
                                      np.asarray(b.device_words), err_msg=f"step {i}")
        assert a.node_stats() == b.node_stats()
        assert a._sel_offset == b._sel_offset
        for k in totals:
            totals[k] += st_a[k]
    assert a.stale_dropped == 0  # the lockstep never enters the stale window
    assert totals["subdivided"] > 0 and totals["collapsed"] > 0
    assert tuple(img_a.shape) == (RES, RES, 3) and res_a.hit.shape == (RES * RES,)
    if config == "sync_fb2_warp":
        assert a._warp_table is not None and a._warp_incremental > 0


def test_deferred_stale_window_keeps_partition():
    """The one-frame window of deferred feedback: a frame that looks away
    selects every interior for collapse; the next frame looks back and
    re-visits the groups that batch then frees. Its selection runs on the
    pool after the collapse, whose freed groups still hold their old words,
    so hot leaves inside freed groups come back as subdivide candidates.

    The JAX Session drops such stale candidates only when the pool changed
    bucket (``session.py:510-514``), so it subdivides slots of freed groups
    here and its pool diverges from the port's. The port always drops the
    slots freed by the batch just applied, and its pool keeps the
    reachable + holes partition at every step."""
    s = _port_session()
    away = -LOOK
    looks = [LOOK] * 8 + [away] + [LOOK] * 4
    for look in looks:
        s.character.look = np.asarray(look, np.float32)
        s.step()
        assert_partition(s.octree)
        assert_pool_is_host(s)
    assert s.stale_dropped > 0
    assert len(s.octree.hole_stack) > 0


def test_deferred_churn_keeps_partition():
    """Grow, look away, regrow at fb1 under deferred feedback (as
    tests/test_session.py:363-385): the partition holds and the device pool
    equals the host octree at every step."""
    s = _port_session()
    looks = [LOOK] * 5 + [-LOOK] * 5 + [LOOK] * 5
    collapsed = 0
    for look in looks:
        s.character.look = np.asarray(look, np.float32)
        collapsed += s.step()[2]["collapsed"]
        assert_partition(s.octree)
        assert_pool_is_host(s)
    assert collapsed > 0


def test_deferred_converges_to_sync():
    """Deferral shifts when patches land, not where the tree converges."""
    sync, deferred = _port_session(deferred_feedback=False), _port_session()
    assert deferred.step()[2] == {"subdivided": 0, "collapsed": 0, "patched": 0}
    first = sync.step()[2]
    assert deferred.step()[2] == first and first["subdivided"] > 0
    for _ in range(20):  # fb1 deferral takes two steps per tree level
        sync.step()
        deferred.step()
    deferred.step()
    np.testing.assert_array_equal(sync.octree.nodes, deferred.octree.nodes)
    assert_pool_is_host(deferred)


def test_native_and_python_engines_agree():
    a, b = _port_session(use_native=True), _port_session(use_native=False)
    assert a.use_native and not b.use_native
    for _ in range(6):
        ia, _, sa = a.step()
        ib, _, sb = b.step()
        assert sa == sb
        np.testing.assert_array_equal(ia.numpy(), ib.numpy())
    np.testing.assert_array_equal(a.octree.nodes, b.octree.nodes)


def test_feedback_cadence_and_pause():
    s = _port_session(deferred_feedback=False, feedback_every=3)
    counted = [bool(sum(s.step()[2].values())) for _ in range(6)]
    assert counted[0] and counted[3] and not any(counted[i] for i in (1, 2, 4, 5))
    s.settings.pause_adaptive = True
    n = len(s.octree)
    for _ in range(3):
        assert s.step()[2] == {"subdivided": 0, "collapsed": 0, "patched": 0}
    assert len(s.octree) == n


def test_show_hits_session_frame():
    s = _port_session(show_hits=True, deferred_feedback=False)
    img, res, _ = s.step()
    grey = img.numpy().reshape(-1, 3)
    assert (grey[:, 0] == grey[:, 1]).all() and (grey[:, 1] == grey[:, 2]).all()
    assert (grey[~res.hit.numpy()] == 0).all() and grey.any()


def test_device_bucket_ladder_equals_jax():
    """The ladder decides the selection's modulus and the warp eligibility,
    so the port keeps JAX's rungs."""
    s = _port_session()
    for cap in (65536, 300_000, 10_000_000):
        s.pool_capacity = cap
        for n in (1, 8, 65536, 65537, 262144, 262145, 1 << 20, (1 << 20) + 1,
                  1 << 22, (1 << 22) + 1):
            s.octree._len = n
            assert s._device_bucket() == JSession._device_bucket(s), (cap, n)


def test_reset_world_and_node_stats():
    s = _port_session(deferred_feedback=False)
    for _ in range(3):
        s.step()
    n, holes = s.node_stats()
    assert n > 8 and holes == 0.0
    s.reset_world(scenes.shell_world(4))
    assert s.node_stats() == (8, 0.0)
    assert s._pending_feedback is None
    assert_pool_is_host(s)
    assert s.step()[2]["subdivided"] > 0


def test_session_defaults_to_the_card(monkeypatch):
    """Built without a device the Session runs on the card; on a host
    without CUDA it raises instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session(scenes.shell_world(3), RES, RES)
    assert Session(scenes.shell_world(3), RES, RES, device="cpu").device.type == "cpu"
