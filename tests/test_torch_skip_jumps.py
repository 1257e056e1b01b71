"""Counted frames that ride a combined warp+skip table decide as a root
descent does: a skip jump marks the empty leaf of every table cell it
crosses, so the visit closure (``feedback.propagate_visits``) leaves the
interior zero-set of the plain reference's frame
(``portbench/reference/trace.py``), whose rays read every node they cross,
and the Session's collapse candidates are the reference rule's
(``portbench/reference/select.py``). Without those marks an interior that
only a jump crosses has no visit and is listed to collapse.
"""

import numpy as np
import pytest
import torch
from jump_marks import assert_reference_zero_set, reference_visits

from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.app import session
from octree_tracer_tpu_torch.app.session import Session
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET
from octree_tracer_tpu_torch.render import camera, skip, tracer
from portbench import compare
from portbench.reference import trace as ref_trace

LEVELS = 3
EMPTY = np.uint32(VOXEL_OFFSET << 4)
# The camera stands in an empty leaf at x < -0.5 and looks along +x.
POS = np.array([-0.95, -0.6, -0.55], np.float32)
LOOK = np.array([1.0, 0.05, 0.02], np.float32)
# Interiors at depth 1 (A's children at x in (-0.5, 0]) whose eight children
# are empty leaves: only the rays' jumps cross them.
CROSSED = np.arange(12, 16)


def _jump_pool() -> np.ndarray:
    """Root child 0 (x, y, z < 0) is interior A, root child 4 (x > 0) is
    interior B; the other root children are empty leaves. A's children at
    x < -0.5 are empty leaves, at x > -0.5 interiors of eight empty leaves
    each (``CROSSED``); B's children at x < 0.5 are empty, at x > 0.5 filled
    leaves. From the camera the skip cube reaches x = 0.5."""
    w = np.full(56, EMPTY, dtype=np.uint32)
    w[0], w[4] = 8 << 4, 16 << 4
    for i in range(4):
        w[CROSSED[i]] = (24 + 8 * i) << 4
        w[20 + i] = (VOXEL_OFFSET + 0x204080 + 0x101010 * i) << 4
    return w


def _frame(flags: bool, restart: bool):
    w = _jump_pool()
    words = state.u32_to_device(w, "cpu")
    table = skip.build_warp_skip_table(words, LEVELS)
    _, ci = camera.camera_matrices(POS, LOOK, 40.0, 8, 8)
    origin, dirs = camera.generate_rays_device(ci, 8, 8, "cpu")
    _, res, visits = tracer.render_frame(words, origin, dirs, u8_image=True, warp_table=table,
                                         with_visits=True, visit_flags=flags,
                                         parent_restart=restart)
    return w, table, origin, dirs, res, visits


@pytest.mark.parametrize("restart", [True, False], ids=["parent", "root"])
@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
def test_jumps_leave_the_reference_zero_set(flags, restart):
    w, table, origin, dirs, res, visits = _frame(flags, restart)
    ref = reference_visits(w, origin.numpy(), dirs.numpy(), shadows=True)
    # The pool puts CROSSED where only jumps go: every ray leaves the
    # camera's leaf in one trip, a jump over the cube that the table stores
    # for its octant (x from -1 up to 0.5 at least), and hits B's filled
    # children at x = 0.5, where its shadow ray starts; no trip reads
    # CROSSED, whose leaves the jumps mark. The reference's rays read it,
    # and the jump counts the boundary steps they take there.
    skip_word = tracer._warp_lookup(tracer.widen_u32(table), LEVELS,
                                    torch.from_numpy(POS)[None], True, True)[4]
    sides = tracer._decode_skip(skip_word, torch.arange(4, 8))
    assert bool((-1.0 + 0.25 * sides >= 0.5).all())
    ref_steps = ref_trace.trace_rays(ref_trace.widen(torch.from_numpy(w.view(np.int32))),
                                     origin, dirs.reshape(-1, 3))["steps"]
    assert bool(res.hit.all()) and torch.equal(res.steps.long(), ref_steps)
    assert bool((ref_steps > 1).all())
    assert bool((res.hit_pos[:, 0] >= 0.5).all())
    v = visits.numpy()
    assert (v[CROSSED] == 0).all() and (v[24:56] > 0).any()
    assert (ref[CROSSED] > 0).all()
    assert_reference_zero_set(w, v, ref, passes=4)


@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
def test_jump_marks_the_leaves_of_the_cells_crossed(flags):
    """One ray along +x through the middle of the cells at y, z = 1 (of 8):
    it reads the camera's leaf (slot 8) and, past the jump, B's filled
    child (20); the jump marks the covering leaves of the cells 2-5 it
    crosses beyond the camera's leaf (27 and 31 under CROSSED's first
    interior, then 16, B's empty child, twice), and nothing else, and
    counts a root descent's four steps: out of 8, 27, 31 and 16."""
    w = _jump_pool()
    words = state.u32_to_device(w, "cpu")
    table = skip.build_warp_skip_table(words, LEVELS)
    visits = torch.zeros(w.shape[0], dtype=torch.int32)
    res = tracer.trace(words, torch.from_numpy(POS)[None],
                       torch.tensor([[1.0, 0.0, 0.0]]), warp_table=table, visits=visits,
                       visit_flags=flags)
    assert bool(res.hit[0]) and int(res.index[0]) == 20 and int(res.steps[0]) == 4
    want = {8: 1, 20: 1, 27: 1, 31: 1, 16: 1 if flags else 2}
    got = {int(i): int(visits[i]) for i in torch.nonzero(visits).flatten()}
    assert got == want


@pytest.mark.parametrize("restart", [True, False], ids=["parent", "root"])
@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
def test_counted_jumps_meet_the_step_cap_where_a_descent_does(flags, restart):
    """Under a step cap that binds, a counted trace on the combined table
    forces the rays a root descent forces, at its positions: every field
    but the depth equals that of the trace without jumps (the table's skip
    half zeroed), which takes each boundary step the descent takes. A jump
    counts the steps it stands for, and none crosses the cap: its cube
    shrinks near it. Uncounted, a jump counts one step, and fewer rays
    reach the cap."""
    words = state.u32_to_device(scenes.deep_shell(6), "cpu")
    table = skip.build_warp_skip_table(words, 4)
    free = table.clone()
    free[1::2] = 0
    _, ci = camera.camera_matrices(np.array([0.3, 0.55, -1.9], np.float32),
                                   np.array([-0.1, -0.3, 1.0], np.float32), 70.0, 32, 32)
    origin, dirs = camera.generate_rays_device(ci, 32, 32, "cpu")
    origins = origin.reshape(1, 3).expand(32 * 32, 3)
    dirs = dirs.reshape(-1, 3)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    kw = dict(max_steps=6, parent_restart=restart)
    got = tracer.trace(words, origins, dirs, warp_table=table, visits=visits,
                       visit_flags=flags, **kw)
    want = tracer.trace(words, origins, dirs, warp_table=free, **kw)
    for f in ("hit", "forced", "index", "hit_pos", "normal", "steps", "word"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    jumped = tracer.trace(words, origins, dirs, warp_table=table, **kw)
    assert int(want.forced.sum()) > int(jumped.forced.sum()) > 0


RES = 24
SESSION_POS = np.array([0.25, 0.35, -2.3], np.float32)
SESSION_LOOK = np.array([-0.12, -0.17, 1.0], np.float32)


def test_shipped_session_candidates_are_the_reference_rule(monkeypatch):
    """A Session with the shipped settings (deferred feedback, the combined
    table with its skip half) from the first frame on, its table at a level
    the CPU builds in a moment: through growth and, after a turn,
    collapses, every step's packed candidate lists are the reference rule
    on the pool that step selected on, under the visits of the reference's
    frame of the pool it traced."""
    monkeypatch.setattr(session, "WARP_LEVELS", 5)
    s = Session(scenes.shell_world(6), RES, RES, pool_capacity=65536, device="cpu")
    s.character.pos, s.character.look = SESSION_POS.copy(), SESSION_LOOK.copy()
    s.settings.fov = 70.0
    s.settings.warp_pool_words = 1
    settings = dict(fov=70.0, width=RES, height=RES, sun=tuple(s.settings.sun_dir),
                    shadows=True)
    totals = {"subdivided": 0, "collapsed": 0, "reference": 0}
    for i in range(9):
        if i == 6:
            s.character.turn(900.0, 300.0, fov=70.0)
        s.render()
        frame_words = s._frame_words
        assert s._warp_table is not None and tracer.warp_table_combined(s._warp_table)
        stats = s.update()
        for k in ("subdivided", "collapsed"):
            totals[k] += stats[k]
        packed, _, _, _, caps, _ = s._pending_feedback
        sel = s.device_words if s.device_words.shape == frame_words.shape else frame_words
        ref = compare.reference_frame(ref_trace.widen(frame_words), s.character.pos,
                                      s.character.look, settings, "cpu", with_visits=True)
        d = compare.candidate_diffs(packed.numpy(), caps, ref_trace.widen(sel),
                                    ref_trace.widen(frame_words), ref["visits"],
                                    min(len(s.octree), int(sel.shape[0])))
        assert d["diffs"] == 0, f"step {i}: {d}"
        totals["reference"] += d["reference"]
    assert all(n > 0 for n in totals.values()), totals


def test_diagonal_jumps_step_every_tied_axis_at_once():
    """The plain walk over a batch of rays (``tracer._jump_slots``, K1's
    ``mark_jump`` loop): rays from a cell's centre along the eight
    diagonals, whose exit planes tie on every axis at every step, enter the
    diagonal's cells alone, one a step, until the first axis leaves the
    cube of ``skw`` cells or the grid, and each marks those cells' covering
    slots; the cells' own slots are ``_cell_slots``'s. The scene is random,
    its level-4 table with a third of its warp words zeroed as the
    Session's patches zero them (those cells descend from the root)."""
    levels, side = 4, 16
    cw = np.float32(2.0 / side)
    words = state.u32_to_device(scenes.random_scene(5, 400, 7), "cpu")
    table = skip.build_warp_skip_table(words, levels)
    table[0::6] = 0
    pool, wide = tracer._pool_rows(words), tracer.widen_u32(table)
    rng = np.random.default_rng(5)
    n = 64
    cells = rng.integers(0, side, (n, 3))
    rs = np.array([[1 - 2 * ((i >> k) & 1) for k in range(3)] for i in range(n)], np.float32)
    skw = rng.choice([1, 2, 3, 5, 8, 16], n)
    centre = ((cells + 0.5) * cw - 1.0).astype(np.float32)
    args = [torch.from_numpy(a) for a in (centre, rs, rs, centre)]
    got = tracer._jump_slots(wide, levels, pool, *args, torch.from_numpy(skw),
                             torch.from_numpy(centre),
                             torch.full((n, 1), float(cw) / 2.0, dtype=torch.float32))
    want = []
    for c, s, w in zip(cells, rs.astype(int), skw):
        room = np.where(s > 0, side - 1 - c, c).min()
        want.append(c + s * np.arange(1, min(w - 1, room) + 1)[:, None])
    want = tracer._cell_slots(wide, levels, pool, torch.from_numpy(np.concatenate(want)))
    assert sorted(got.tolist()) == sorted(want.tolist())
    assert want.numel() > n
