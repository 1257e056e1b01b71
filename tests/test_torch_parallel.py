"""The port's ``parallel``: row-sharded frames and ``ShardedSession`` over
``torch.distributed`` (gloo on CPU processes, the plain versions), against
the port's unsharded ``render_frame`` and ``Session`` and against the JAX
package's ``parallel`` on a virtual CPU mesh of the same size.

Each group of ranks is spawned once (``parallel.launch.run_ranks``) and runs
every scenario of ``torch_parallel_ranks`` in one go; the tests read its
records. Frames are bit-equal to the port's: the image, every
``TraceResult`` field, and the visits, which are the sum of each rank's
(counts equal the unsharded counts; flags equal the sum of the row blocks'
flags, with the unsharded frame's filled-leaf counts and interior zero-set).
Against JAX the rules of ``test_torch_visits.py`` and ``test_torch_render.py``
hold: hits and indices equal, the visits' filled-leaf counts and interior
zero-set equal, u8 images equal (random colours by the u8 rule),
``show_hits`` views within 1e-6 in f32. A 2-rank ``ShardedSession`` is
step-equal to the port's ``Session`` and to JAX's ``ShardedSession``, and
every rank's pool and table equal rank 0's at every step.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from jump_marks import assert_reference_zero_set, reference_visits
from octree_tracer_tpu.adaptive import feedback as jfeedback
from octree_tracer_tpu.core import CpuOctree as JCpuOctree
from octree_tracer_tpu.parallel import ShardedSession as JShardedSession
from octree_tracer_tpu.parallel import make_mesh as jmake_mesh
from octree_tracer_tpu.parallel import render_frame_sharded as jrender_frame_sharded
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.world.world import World as JWorld
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.adaptive import feedback
from octree_tracer_tpu_torch.app.session import Session
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET
from octree_tracer_tpu_torch.parallel import dryrun_multichip, launch, run_ranks
from octree_tracer_tpu_torch.render import tracer

SIZES = (1, 2, 4)
SESSION_RANKS = 2


@functools.lru_cache(maxsize=None)
def _world_chunks():
    return state.world_to_numpy(scenes.shell_world(6))


@pytest.fixture(scope="module")
def groups():
    """Every group of ranks, started together on first use so that they run
    while this process computes the JAX side; ``groups(key)`` waits for one:
    ``("frames", n)`` or ``"sessions"``."""
    with ThreadPoolExecutor(max_workers=len(SIZES) + 1) as pool:
        runs = {("frames", n): pool.submit(run_ranks, R.frames, n, "cpu") for n in SIZES}
        runs["schedules"] = pool.submit(run_ranks, R.schedule_frames, 2, "cpu")
        runs["sessions"] = pool.submit(run_ranks, R.session_lockstep, SESSION_RANKS, "cpu",
                                       _world_chunks())
        yield lambda key: runs[key].result()


@functools.lru_cache(maxsize=None)
def _table(scene):
    return R.table_words(scene)


@functools.lru_cache(maxsize=None)
def _port_frame(case, mode, rows=None):
    """The port's unsharded ``render_frame`` of a case, or of its row block
    ``rows`` (start, stop)."""
    scene, w, h, cam, table = R.FRAME_CASES[case]
    words = state.u32_to_device(R.SCENES[scene](), "cpu")
    tab = state.table_to_device(_table(scene), "cpu") if table else None
    origin, dirs = R.rays(cam, w, h)
    if rows is not None:
        dirs = dirs[rows[0]:rows[1]].contiguous()
    img, res, visits = tracer.render_frame(words, origin, dirs, u8_image=mode != "show_hits",
                                           warp_table=tab, **R.MODES[mode])
    return img.numpy(), tracer.to_numpy(res), None if visits is None else visits.numpy()


def _kinds(scene):
    words = R.SCENES[scene]()
    payload = words >> np.uint32(4)
    return payload > VOXEL_OFFSET, (payload < VOXEL_OFFSET) & (words != 0)


FRAME_TESTS = [(n, case, mode) for n in SIZES for case in R.FRAME_CASES for mode in R.MODES]


@pytest.mark.parametrize("n,case,mode", FRAME_TESTS,
                         ids=[f"{n}ranks-{c}-{m}" for n, c, m in FRAME_TESTS])
def test_sharded_frame_equals_port(groups, n, case, mode):
    """Every rank returns the whole frame, equal to the port's
    ``render_frame`` on the image (shard-local for ``show_hits``, as the
    row blocks' own frames) and on every result field; the visits are the
    sum of the row blocks' visits."""
    _, _, h, _, _ = R.FRAME_CASES[case]
    img, res, visits = _port_frame(case, mode)
    rows = h // n
    blocks = [_port_frame(case, mode, (r * rows, (r + 1) * rows)) for r in range(n)]
    want_visits = None if visits is None else sum(b[2] for b in blocks)
    if mode == "show_hits":
        img = np.concatenate([b[0] for b in blocks])
    for rank, out in enumerate(groups(("frames", n))):
        s_img, s_res, s_visits = out["frames"][case, mode]
        np.testing.assert_array_equal(s_img, img, err_msg=f"rank {rank}")
        for field in res:
            np.testing.assert_array_equal(s_res[field], res[field],
                                          err_msg=f"rank {rank}: {field}")
        if visits is None:
            assert s_visits is None
            continue
        np.testing.assert_array_equal(s_visits, want_visits, err_msg=f"rank {rank}")
        filled, interior = _kinds(R.FRAME_CASES[case][0])
        np.testing.assert_array_equal(s_visits[filled], visits[filled])
        np.testing.assert_array_equal(s_visits[interior] == 0, visits[interior] == 0)
        if mode != "flags":  # counts sum to the unsharded counts
            np.testing.assert_array_equal(s_visits, visits)
    assert res["hit"].any() and not res["hit"].all()


@pytest.mark.parametrize("case,mode", list(R.SCHEDULE_FRAMES),
                         ids=[f"{c}-{m}" for c, m in R.SCHEDULE_FRAMES])
def test_sharded_schedule_frames_equal_port(groups, case, mode):
    """JAX's ``mode``, ``beams`` and ``tile_size`` through the sharded frame
    on 2 ranks (16 rows each, whole 8x8 tiles): each rank's image and
    result equal the port's unsharded ``render_frame`` with the same
    keywords, and the visits the sum of its row blocks' frames, which for
    counts is the unsharded frame's (a row block's tiles are the frame's)."""
    scene, w, h, cam, table = R.FRAME_CASES[case]
    kw = R.SCHEDULE_FRAMES[case, mode]
    words = state.u32_to_device(R.SCENES[scene](), "cpu")
    tab = state.table_to_device(_table(scene), "cpu") if table else None
    origin, dirs = R.rays(cam, w, h)

    def frame(d):
        img, res, visits = tracer.render_frame(words, origin, d.contiguous(), u8_image=True,
                                               warp_table=tab, **kw)
        return img.numpy(), tracer.to_numpy(res), None if visits is None else visits.numpy()

    img, res, visits = frame(dirs)
    blocks = [frame(dirs[r * h // 2:(r + 1) * h // 2]) for r in range(2)]
    for rank, out in enumerate(groups("schedules")):
        s_img, s_res, s_visits = out[case, mode]
        np.testing.assert_array_equal(s_img, img, err_msg=f"rank {rank}")
        for field in res:
            np.testing.assert_array_equal(s_res[field], res[field],
                                          err_msg=f"rank {rank}: {field}")
        if visits is None:
            assert s_visits is None
            continue
        np.testing.assert_array_equal(s_visits, sum(b[2] for b in blocks))
        if not kw.get("visit_flags"):
            np.testing.assert_array_equal(s_visits, visits)
    assert res["hit"].any()


@pytest.mark.parametrize("n", [2, 4])
def test_uneven_height_raises(groups, n):
    """A frame or a ShardedSession whose height does not divide by the
    mesh size raises ValueError on every rank."""
    for out in groups(("frames", n)):
        assert out["uneven"] == [True, True]


def test_frame_collectives_are_counted(groups):
    """Per frame: one all-reduce of the pool's int32 visits when counting,
    and two all-gathers (the packed result and the image)."""
    for n in SIZES:
        t = groups(("frames", n))[0]["traffic"]
        frames = len(R.FRAME_CASES) * len(R.MODES)
        assert t["frame_gather"]["calls"] == 2 * frames
        assert t["visits"]["calls"] == len(R.FRAME_CASES) * 3
        assert t["replicate"]["calls"] == 2 * 2 * len(R.SCENES)


# JAX's tiled mode takes no table and no flags; its staged mode does, and
# compiles for about 20 s on the CPU. (Its beam mode's interior zero-set
# under a table from inside the cube differs from staged's, closure and all,
# on 16 of this scene's 3,292 interiors.)
JAX_FRAME_TESTS = (
    [(n, "shell6-32x32-bench", m) for n in SIZES for m in ("image", "counts", "show_hits")]
    + [(n, "random6-32x32-inside", m) for n in (2, 4) for m in ("image", "counts")]
    + [(2, "random6-32x32-inside-L7", "flags"), (4, "random6-40x24-inside-L7", "counts")])


@pytest.mark.parametrize("n,case,mode", JAX_FRAME_TESTS,
                         ids=[f"{n}ranks-{c}-{m}" for n, c, m in JAX_FRAME_TESTS])
def test_sharded_frame_equals_jax(groups, n, case, mode):
    """The port's sharded frame against JAX's ``render_frame_sharded`` on a
    mesh of ``n`` virtual CPU devices (tiled mode; staged for flags and
    tables): hit and index equal; the
    visits' filled-leaf counts and interior zero-set equal (under a table
    closed with ``propagate_visits``, and the zero-set the plain
    reference's, inside JAX's); u8 images equal on the shell and
    by the u8 rule of ``test_torch_render.py`` on random colours (XLA's CPU
    ``pow`` rounds knife-edge values the other way, the port's unsharded
    frame against JAX's too); ``show_hits`` views, shard-local in both,
    within 1e-6."""
    scene, w, h, cam, table = R.FRAME_CASES[case]
    words = R.SCENES[scene]()
    tab = _table(scene) if table else None
    origin, dirs = R.rays(cam, w, h)
    mode_j = "staged" if mode == "flags" or table else "tiled"
    img_j, res_j, visits_j = jrender_frame_sharded(
        jmake_mesh(jax.devices()[:n]), jnp.asarray(words), jnp.asarray(origin.numpy()),
        jnp.asarray(dirs.numpy()), jnp.asarray(jtracer.DEFAULT_SUN), mode=mode_j,
        u8_image=mode != "show_hits", warp_table=None if tab is None else jnp.asarray(tab),
        **R.MODES[mode])
    img, res, visits = groups(("frames", n))[0]["frames"][case, mode]
    if mode == "show_hits":
        np.testing.assert_allclose(img, np.asarray(img_j), rtol=1e-6, atol=0)
        assert img.any()
    elif scene == "shell6":
        np.testing.assert_array_equal(img, np.asarray(img_j))
    else:
        diff = np.abs(img.astype(np.int32) - np.asarray(img_j).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    np.testing.assert_array_equal(res["hit"], np.asarray(res_j.hit))
    np.testing.assert_array_equal(res["index"], np.asarray(res_j.index))
    if visits is None:
        return
    v, vj = visits, np.asarray(visits_j)
    filled, interior = _kinds(scene)
    if table:
        # The port's jumps mark the empty leaves of the cells they cross,
        # JAX's do not (tests/jump_marks.py): the closure leaves the
        # reference frame's zero-set, inside JAX's.
        passes = 7  # leaves at depth 6
        assert_reference_zero_set(words, v, reference_visits(
            words, origin.numpy(), dirs.numpy(), shadows=True), passes)
        v = feedback.propagate_visits(state.u32_to_device(words, "cpu"),
                                      torch.from_numpy(v), passes).numpy()
        vj = np.asarray(jfeedback.propagate_visits(jnp.asarray(words), visits_j,
                                                   passes=passes))
        np.testing.assert_array_equal(v[filled], vj[filled])
        assert ((vj[interior] == 0) >= (v[interior] == 0)).all()
    else:
        np.testing.assert_array_equal(v[filled], vj[filled])
        np.testing.assert_array_equal(v[interior] == 0, vj[interior] == 0)
    assert v[filled].sum() > 0 and (v[interior] == 0).any() and (v[interior] > 0).any()


def _jax_world(chunks):
    world = JWorld(load_blocks=False)
    for cid, (ptrs, vals, top_mip) in chunks.items():
        world.chunks[cid] = JCpuOctree.from_arrays(ptrs, vals, top_mip=top_mip)
    return world


def _configure(s, config):
    s.character.pos, s.character.look = R.SESSION_POS.copy(), R.SESSION_LOOK.copy()
    s.settings.fov = 70.0
    for k, v in R.SESSION_CONFIGS[config].items():
        setattr(s.settings, k, v)


@pytest.mark.parametrize("config", list(R.SESSION_CONFIGS))
def test_sharded_session_lockstep(groups, config):
    """Rank 0 of a 2-rank ``ShardedSession`` in lockstep with the port's
    ``Session`` and with JAX's ``ShardedSession`` on a 2-device mesh, 11
    steps with a turn at 7: images, stats, node_stats, the selection offset
    and the pool equal at every step, through growth and collapses."""
    chunks = _world_chunks()
    port = Session(state.world_from_numpy(chunks), R.SESSION_RES, R.SESSION_RES,
                   pool_capacity=65536, device="cpu")
    jax_s = JShardedSession(_jax_world(chunks), jmake_mesh(jax.devices()[:SESSION_RANKS]),
                            width=R.SESSION_RES, height=R.SESSION_RES, pool_capacity=65536)
    for s in (port, jax_s):
        _configure(s, config)
    run = groups("sessions")[0][config]
    totals = {"subdivided": 0, "collapsed": 0}
    for i, rec in enumerate(run["steps"]):
        if i == R.SESSION_TURN:
            for s in (port, jax_s):
                s.character.turn(900.0, 300.0, fov=70.0)
        img_p, res_p, st_p = port.step()
        img_j, _, st_j = jax_s.step()
        np.testing.assert_array_equal(rec["img"], img_p.numpy(), err_msg=f"step {i}")
        np.testing.assert_array_equal(rec["img"], np.asarray(img_j), err_msg=f"step {i}")
        np.testing.assert_array_equal(rec["hit"], res_p.hit.numpy(), err_msg=f"step {i}")
        assert rec["stats"] == st_p == st_j, f"step {i}"
        assert rec["node_stats"] == port.node_stats() == jax_s.node_stats(), f"step {i}"
        assert rec["sel_offset"] == port._sel_offset == jax_s._sel_offset, f"step {i}"
        np.testing.assert_array_equal(rec["pool"], state.to_numpy_u32(port.device_words))
        np.testing.assert_array_equal(rec["pool"], np.asarray(jax_s.device_words))
        for k in totals:
            totals[k] += rec["stats"][k]
    assert totals["subdivided"] > 0 and totals["collapsed"] > 0, totals
    assert run["stale_dropped"] == port.stale_dropped == 0
    if config == "sync_fb2_warp":
        assert run["table"] and run["warp_incremental"] > 0


@pytest.mark.parametrize("config", list(R.SESSION_CONFIGS))
def test_sharded_session_rank_state(groups, config):
    """Every rank's device pool and table equal rank 0's at every step, and
    every rank returns rank 0's image, stats and node_stats."""
    runs = [r[config]["steps"] for r in groups("sessions")]
    for i, recs in enumerate(zip(*runs)):
        first = recs[0]
        for rank, rec in enumerate(recs[1:], start=1):
            for key in ("pool_digest", "table_digest", "stats", "node_stats", "sel_offset"):
                assert rec[key] == first[key], f"step {i}, rank {rank}: {key}"
            np.testing.assert_array_equal(rec["img"], first["img"])
            np.testing.assert_array_equal(rec["hit"], first["hit"])
    if config == "sync_fb2_warp":
        assert runs[0][-1]["table_digest"] != "none"


def test_dryrun_multichip_cpu(capsys):
    out = dryrun_multichip(2, device="cpu")
    assert out["subdivided"] > 0 and out["bucket_words"] == 65536
    assert out["visits_all_reduce_mb"] == 65536 * 4 / 1e6
    assert 0 < out["largest_step_payload_kb"] and 0 < out["frame_all_gather_mb"]
    printed = capsys.readouterr().out
    assert "visit all-reduce" in printed and "frame all-gather" in printed


def test_backend_follows_the_devices(monkeypatch):
    """NCCL with a card a rank, gloo when ranks share a card or on CPU
    processes; a card asked for on a host without one raises."""
    assert launch.backend_for("cpu", 4) == "gloo"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.backend_for("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert launch.backend_for("cuda", 2) == "nccl"
    assert launch.backend_for("cuda", 4) == "gloo"


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_ranks(R.fail_on_rank, 2, "cpu", 1)
