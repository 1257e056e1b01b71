"""The JAX frame's ray orders and schedule pre-passes in the port, against
JAX on the CPU (the port's plain versions of kernels K1, K3 and K11).

- Block orders: ``tracer._pixel_to_block`` and ``_block_to_pixel``, the
  row-major tile form and the Morton form, equal JAX's, exact, and undo
  each other.
- K3's block form: ``generate_rays_device_plain(block_major=b)`` equals JAX
  ``_device_raygen(w, h, b)`` within 2e-7 (the tolerance of
  ``test_torch_camera.py``: the two sum the 4x4 product in different
  orders), and its own pixel form after ``_pixel_to_block`` exactly.
- K11: ``beam_start_plain`` equals JAX ``beam_start`` exactly, every start
  field and ``beam_visit_idx``, from outside the root cube (a camera on the
  cube's edge, whose tiles straddle two faces) and from inside it.
- K1's start forms: ``trace(start=)`` with JAX's own beam starts equals JAX
  ``trace(start=)`` on every field (``hit_pos`` within the repository's
  1e-5) and every visit count, without a table and with the combined table,
  in both restart forms; the rays start inside the root cube where a table
  rides along (``test_torch_restart.py`` says why).
- ``trace_staged``: against JAX's, without and with ``beam_shape`` (the
  block-order record ``beam_aux`` exact), and its visits by the two
  invariants the LOD thresholds read.
- K1's seed forms: ``trace`` and ``trace_shadow`` with ``warp_in_body=False``
  (a warp table or combined table read for first descents only) against
  JAX ``trace_staged``'s fields exactly, and their visits against JAX
  ``trace`` started at the table's cells exactly, in both restart forms.
- ``fast_ranks``, ``fast_nonzero`` and ``pad_patches``: exact, JAX's error
  past the last bucket too.
- Every ``ValueError`` JAX raises for a schedule combination, the port
  raises.

Scenes stay at 12 levels or fewer (ROADMAP §3).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jump_marks import (assert_jax_marks_with_jumps, assert_reference_zero_set,
                        reference_visits, skip_free)

from octree_tracer_tpu.adaptive import feedback as jfeedback
from octree_tracer_tpu.render import camera as jcam
from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu_torch import adaptive, scenes, state
from octree_tracer_tpu_torch.adaptive import feedback
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET
from octree_tracer_tpu_torch.render import camera as tcam
from octree_tracer_tpu_torch.render import tracer as ttracer

RES = 32
LEVELS = 4
EXACT = ("hit", "forced", "index", "steps", "depth", "normal", "word")
CAMERAS = {
    "bench": (np.array([0.4, 0.6, -2.2], np.float32),
              np.array([-0.2, -0.35, 1.0], np.float32)),
    # Looking past the cube's vertical edge x = 1, z = -1, which crosses
    # the image off its centre: the 8x8 tiles along it take rays through
    # both faces.
    "edge": (np.array([2.0, 0.3, -2.0], np.float32),
             np.array([-1.0, -0.1, 0.85], np.float32)),
    "inside": (np.array([-0.35, 0.55, -0.6], np.float32),
               np.array([0.3, -0.5, 1.0], np.float32)),
}
SCENES = {
    "shell5": lambda: scenes.deep_shell(5),
    "random6": lambda: scenes.random_scene(6, 1500, 3),
}


@functools.lru_cache(maxsize=None)
def _words(scene):
    return SCENES[scene]()


@functools.lru_cache(maxsize=None)
def _table(scene):
    return np.asarray(jskip.build_warp_skip_table(jnp.asarray(_words(scene)), LEVELS))


@functools.lru_cache(maxsize=None)
def _rays(cam, res=RES):
    pos, look = CAMERAS[cam]
    _, ci = jcam.camera_matrices(pos, look, 70.0, res, res)
    o, d = jcam.generate_rays(ci, res, res)
    return np.asarray(o), np.asarray(d)


def _t(a):
    return torch.from_numpy(np.array(a))


def _kinds(words):
    payload = words >> np.uint32(4)
    return payload > VOXEL_OFFSET, (payload < VOXEL_OFFSET) & (words != 0)


def _assert_exact(a, b, fields=EXACT):
    for f in fields:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert np.abs(a["hit_pos"] - b["hit_pos"]).max() <= 1e-5


# -- block orders --------------------------------------------------------


@pytest.mark.parametrize("morton", [False, True], ids=["rows", "morton"])
@pytest.mark.parametrize("block", [2, 4, 8, 16])
def test_block_orders_equal_jax(block, morton):
    h, w = 32, 48
    x = np.random.default_rng(block).standard_normal((h * w, 3)).astype(np.float32)
    fwd = ttracer._pixel_to_block(_t(x), h, w, block, morton)
    np.testing.assert_array_equal(
        fwd.numpy(), np.asarray(jtracer._pixel_to_block(jnp.asarray(x), h, w, block, morton)))
    back = ttracer._block_to_pixel(fwd, h, w, block, morton)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        ttracer._block_to_pixel(_t(x), h, w, block, morton).numpy(),
        np.asarray(jtracer._block_to_pixel(jnp.asarray(x), h, w, block, morton)))
    flags = _t(np.arange(h * w) % 3 == 0)  # a 1-D field
    assert torch.equal(ttracer._block_to_pixel(
        ttracer._pixel_to_block(flags, h, w, block, morton), h, w, block, morton), flags)


def test_block_orders_reject_bad_blocks():
    x = torch.zeros(24 * 16, 3)
    with pytest.raises(ValueError):
        ttracer._pixel_to_block(x, 24, 16, 5)
    with pytest.raises(ValueError):
        ttracer._pixel_to_block(x, 24, 16, 6, True)  # Morton needs a power of two
    assert ttracer._pixel_to_block(x, 24, 16, 8, True).shape == x.shape


# -- K3's block form -----------------------------------------------------


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("cam", ["bench", "inside"])
def test_raygen_block_major_equals_jax(cam, block):
    pos, look = CAMERAS[cam]
    w, h = 64, 48
    _, ci = jcam.camera_matrices(pos, look, 70.0, w, h)
    o_t, d_t = tcam.generate_rays_device_plain(torch.from_numpy(ci), w, h, block_major=block)
    o_j, d_j = jcam._device_raygen(w, h, block)(jnp.asarray(ci))
    assert tuple(d_t.shape) == (h * w, 3) == tuple(d_j.shape)
    assert np.abs(d_t.numpy() - np.asarray(d_j)).max() <= 2e-7
    assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= 2e-7
    o_p, d_p = tcam.generate_rays_device(ci, w, h, "cpu")
    assert torch.equal(d_t, ttracer._pixel_to_block(d_p.reshape(-1, 3), h, w, block))
    assert torch.equal(o_t, o_p)
    o_c, d_c = tcam.generate_rays_device(ci, w, h, "cpu", block_major=block)
    assert torch.equal(d_c, d_t) and torch.equal(o_c, o_t)


def test_raygen_block_major_rejects_bad_blocks():
    ci = jcam.camera_matrices(*CAMERAS["bench"], 70.0, 40, 24)[1]
    for block in (-1, 3, 16):
        with pytest.raises(ValueError):
            tcam.generate_rays_device(ci, 40, 24, "cpu", block_major=block)


# -- K11 -------------------------------------------------------------------


def _straddling_tiles(o, d, block):
    """Tiles whose four corner rays enter the root cube through more than
    one face."""
    entry, entered = ttracer._entry_points(_t(o).reshape(1, 3).expand(RES * RES, 3),
                                           _t(d).reshape(-1, 3))
    face = torch.argmax(entry.abs(), dim=1).reshape(RES, RES)
    n = 0
    for y in range(0, RES, block):
        for x in range(0, RES, block):
            ends = [(y, x), (y + block - 1, x), (y, x + block - 1),
                    (y + block - 1, x + block - 1)]
            if all(bool(entered.reshape(RES, RES)[p]) for p in ends):
                n += len({int(face[p]) for p in ends}) > 1
    return n


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "ge"])
@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("cam", ["edge", "inside"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_beam_start_equals_jax(scene, cam, block, strict):
    words = _words(scene)
    o, d = _rays(cam)
    (ji, jp, jd), jv = jtracer.beam_start(jnp.asarray(words), jnp.asarray(o), jnp.asarray(d),
                                          block=block, strict_descent=strict)
    (ti, tp, td), tv = ttracer.beam_start(state.u32_to_device(words, "cpu"), _t(o), _t(d),
                                          block=block, strict_descent=strict)
    assert ti.dtype == td.dtype == tv.dtype == torch.int32 and tp.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tuple(tv.shape) == ((RES // block) ** 2, 12)
    if cam == "inside":
        assert int((td > 0).sum()) > 0 and int((tv < words.shape[0]).sum()) > 0
    elif block == 8:
        assert _straddling_tiles(o, d, block) > 0


def test_beam_start_depth_cap_and_checks():
    """``max_beam_depth`` caps the walk (0: every ray at the root, no marks)
    as JAX's; a block that does not divide the image raises."""
    words, (o, d) = _words("shell5"), _rays("inside")
    for depth in (0, 1, 3):
        (ji, jp, jd), jv = jtracer.beam_start(jnp.asarray(words), jnp.asarray(o),
                                              jnp.asarray(d), block=8, max_beam_depth=depth)
        (ti, tp, td), tv = ttracer.beam_start(state.u32_to_device(words, "cpu"), _t(o), _t(d),
                                              block=8, max_beam_depth=depth)
        for a, b in ((ti, ji), (tp, jp), (td, jd), (tv, jv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(td.max()) <= depth and tuple(tv.shape) == (16, depth)
    with pytest.raises(ValueError):
        ttracer.beam_start(state.u32_to_device(words, "cpu"), _t(o), _t(d), block=12)


# -- K1's start forms ------------------------------------------------------


@pytest.mark.parametrize("restart", [True, False], ids=["parent", "root"])
@pytest.mark.parametrize("table", ["none", "combined"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_trace_start_equals_jax(scene, table, restart):
    """JAX's beam starts (block 8) into both traces; every field and every
    visit count equal, but the combined table's jump marks of empty leaves
    and steps (``jump_marks``), under which the closure leaves the
    reference's zero-set."""
    words = _words(scene)
    o, d = _rays("inside")
    (ji, jp, jd), _ = jtracer.beam_start(jnp.asarray(words), jnp.asarray(o), jnp.asarray(d),
                                         block=8)
    assert int((np.asarray(jd) > 0).sum()) > 0
    tab = None if table == "none" else _table(scene)
    n = RES * RES
    origins = np.broadcast_to(o, (n, 3)).copy()
    flat = d.reshape(-1, 3)
    res_j, visits_j = jtracer.trace(
        jnp.asarray(words), jnp.asarray(origins), jnp.asarray(flat), start=(ji, jp, jd),
        with_visits=True, parent_restart=restart,
        warp_table=None if tab is None else jnp.asarray(tab))
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    res = ttracer.trace(
        state.u32_to_device(words, "cpu"), _t(origins), _t(flat), visits=visits,
        start=(_t(ji), _t(jp), _t(jd)), parent_restart=restart,
        warp_table=None if tab is None else state.table_to_device(tab, "cpu"))
    b = ttracer.to_numpy(res_j)
    if tab is not None:
        b["steps"] = ttracer.to_numpy(jtracer.trace(
            jnp.asarray(words), jnp.asarray(origins), jnp.asarray(flat), start=(ji, jp, jd),
            parent_restart=restart, warp_table=jnp.asarray(skip_free(tab)))[0])["steps"]
    _assert_exact(ttracer.to_numpy(res), b)
    if tab is None:
        np.testing.assert_array_equal(visits.numpy(), np.asarray(visits_j))
    else:
        assert_jax_marks_with_jumps(words, visits.numpy(), np.asarray(visits_j))
        assert_reference_zero_set(words, visits.numpy(), reference_visits(words, o, flat))


@pytest.mark.parametrize("table", ["none", "combined"])
def test_trace_start_keeps_hits(table):
    """Starts from ``beam_start`` change no hit field of the port's own
    trace; without a table no field at all, and fewer trips (as visits)."""
    words = state.u32_to_device(_words("random6"), "cpu")
    o, d = _rays("inside")
    n = RES * RES
    origins, flat = _t(o).reshape(1, 3).expand(n, 3), _t(d).reshape(-1, 3)
    tab = None if table == "none" else state.table_to_device(_table("random6"), "cpu")
    start, _ = ttracer.beam_start(words, _t(o), _t(d), 8)
    v0, v1 = torch.zeros(words.shape[0], dtype=torch.int32), torch.zeros(
        words.shape[0], dtype=torch.int32)
    a = ttracer.trace(words, origins, flat, warp_table=tab, visits=v0)
    b = ttracer.trace(words, origins, flat, warp_table=tab, start=start, visits=v1)
    for f in ("hit", "forced", "index", "hit_pos", "normal", "word"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    if tab is None:
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert int(v1.sum()) < int(v0.sum())


def test_trace_start_and_knob_checks():
    words = state.u32_to_device(_words("shell5"), "cpu")
    o, d = _rays("inside")
    n = RES * RES
    origins, flat = _t(o).reshape(1, 3).expand(n, 3), _t(d).reshape(-1, 3)
    start, _ = ttracer.beam_start(words, _t(o), _t(d), 8)
    with pytest.raises(ValueError):  # one start a ray
        ttracer.trace(words, origins, flat, start=tuple(s[:-1] for s in start))
    with pytest.raises(TypeError):
        ttracer.trace(words, origins, flat, start=(start[0].long(), start[1], start[2]))
    tab = state.table_to_device(_table("shell5"), "cpu")
    with pytest.raises(ValueError):
        ttracer.trace(words, origins, flat, warp_table=tab, warp_levels=LEVELS + 1)
    base = ttracer.trace(words, origins, flat, warp_table=tab)
    knobs = ttracer.trace(words, origins, flat, warp_table=tab, warp_levels=LEVELS, unroll=4,
                          fuse_sibling=True)
    assert all(torch.equal(x, y) for x, y in zip(base, knobs))
    from octree_tracer_tpu_torch.render import bricks
    dec, br = bricks.build_bricks(words)
    with pytest.raises(ValueError):  # JAX: bricks exclude warp_table/fuse_sibling
        ttracer.trace(dec, origins, flat, bricks=br, fuse_sibling=True)
    with pytest.raises(ValueError):
        jtracer.trace(jnp.asarray(state.to_numpy_u32(dec)), jnp.asarray(origins),
                      jnp.asarray(flat), bricks=jnp.asarray(state.to_numpy_u32(br)),
                      fuse_sibling=True)


# -- trace_staged ----------------------------------------------------------


@pytest.mark.parametrize("beam", [False, True], ids=["staged", "beam_shape"])
def test_trace_staged_equals_jax(beam):
    """Every field exact (hit_pos within 1e-5); visits by the two
    invariants (JAX's beam stage counts a block's shared descent once);
    under ``beam_shape`` the result and the ``beam_aux`` record in the
    block order (``beam_raw``) from block-order rays
    (``beam_pre_permuted``), the record's integer lanes exact."""
    words = _words("random6")
    o, d = _rays("bench")
    n = RES * RES
    origins = np.broadcast_to(o, (n, 3)).copy()
    flat = d.reshape(-1, 3)
    kw = dict(with_visits=True)
    if beam:
        order = (RES, RES, 8)
        origins_in, flat = ttracer._pixel_to_block(_t(origins), *order).numpy(), \
            ttracer._pixel_to_block(_t(flat), *order).numpy()
        kw.update(beam_shape=order, beam_raw=True, beam_pre_permuted=True, beam_aux=True)
    else:
        origins_in = origins
    out_j = jtracer.trace_staged(jnp.asarray(words), jnp.asarray(origins_in),
                                 jnp.asarray(flat), **kw)
    out_t = ttracer.trace_staged(state.u32_to_device(words, "cpu"), _t(origins_in),
                                 _t(flat), **kw)
    assert len(out_t) == len(out_j)
    _assert_exact(ttracer.to_numpy(out_t[0]), ttracer.to_numpy(out_j[0]))
    v, vj = out_t[1].numpy(), np.asarray(out_j[1])
    filled, interior = _kinds(words)
    np.testing.assert_array_equal(v[filled], vj[filled])
    np.testing.assert_array_equal(v[interior] == 0, vj[interior] == 0)
    if beam:
        rec, rec_j = out_t[2].numpy(), np.asarray(out_j[2])
        assert rec.shape == rec_j.shape == (n, 8)
        for lane in (0, 1, 5, 6, 7):
            np.testing.assert_array_equal(rec[:, lane], rec_j[:, lane], err_msg=str(lane))
    # The port's own trace gives the same hits in pixel order.
    plain = ttracer.trace(state.u32_to_device(words, "cpu"), _t(origins), _t(d.reshape(-1, 3)))
    got = out_t[0] if not beam else ttracer.TraceResult(
        *(ttracer._block_to_pixel(f, RES, RES, 8) for f in out_t[0]))
    for f in ("hit", "index", "hit_pos", "normal", "steps", "depth", "word"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


def test_trace_staged_table_and_slim_equal_jax():
    """A combined table read only for the first descent (JAX's default
    ``warp_in_body=False``) and a slim result (index -1, position and word
    0), from inside the root cube."""
    words, tab = _words("random6"), _table("random6")
    o, d = _rays("inside")
    n = RES * RES
    origins, flat = np.broadcast_to(o, (n, 3)).copy(), d.reshape(-1, 3)
    active = np.arange(n) % 5 != 0
    res_j, _ = jtracer.trace_staged(jnp.asarray(words), jnp.asarray(origins),
                                    jnp.asarray(flat), active_init=jnp.asarray(active),
                                    warp_table=jnp.asarray(tab), slim_result=True)
    res_t, vis = ttracer.trace_staged(state.u32_to_device(words, "cpu"), _t(origins),
                                      _t(flat), active_init=_t(active),
                                      warp_table=state.table_to_device(tab, "cpu"),
                                      slim_result=True)
    assert vis is None
    _assert_exact(ttracer.to_numpy(res_t), ttracer.to_numpy(res_j))
    assert bool((res_t.index == -1).all()) and not bool(res_t.hit_pos.any())
    assert bool(res_t.hit.any())


@functools.lru_cache(maxsize=None)
def _any_table(scene, kind):
    if kind == "combined":
        return _table(scene)
    return np.asarray(jtracer.build_warp_table(jnp.asarray(_words(scene)), LEVELS))


@pytest.mark.parametrize("restart", [True, False], ids=["parent", "root"])
@pytest.mark.parametrize("kind", ["warp", "combined"])
def test_trace_table_first_descent_only_equals_jax(kind, restart):
    """``trace(warp_in_body=False)``: the table, of either kind, read for
    each ray's first descent only (K1's seed forms). Every field equal to
    JAX ``trace_staged``'s with the same table (its default
    ``warp_in_body=False``; ``hit_pos`` within 1e-5) and every visit count
    equal to JAX ``trace`` started at the table's cells (the same
    descents, without the staged replays); the flags are the counts'
    nonzero set. A start given wins over the table."""
    words, tab = _words("random6"), _any_table("random6", kind)
    o, d = _rays("inside")
    n = RES * RES
    origins, flat = np.broadcast_to(o, (n, 3)).copy(), d.reshape(-1, 3)
    res_j, _ = jtracer.trace_staged(jnp.asarray(words), jnp.asarray(origins),
                                    jnp.asarray(flat), warp_table=jnp.asarray(tab),
                                    parent_restart=restart)
    wt, tt = state.u32_to_device(words, "cpu"), state.table_to_device(tab, "cpu")
    start = ttracer._warp_start(tt, _t(origins), _t(flat), True)
    assert int((start[2] > 0).sum()) > 0
    _, visits_j = jtracer.trace(jnp.asarray(words), jnp.asarray(origins), jnp.asarray(flat),
                                start=tuple(jnp.asarray(s.numpy()) for s in start),
                                with_visits=True, parent_restart=restart)
    visits, flags = (torch.zeros(words.shape[0], dtype=torch.int32) for _ in range(2))
    kw = dict(warp_table=tt, warp_in_body=False, parent_restart=restart)
    res = ttracer.trace(wt, _t(origins), _t(flat), visits=visits, **kw)
    flagged = ttracer.trace(wt, _t(origins), _t(flat), visits=flags, visit_flags=True, **kw)
    _assert_exact(ttracer.to_numpy(res), ttracer.to_numpy(res_j))
    np.testing.assert_array_equal(visits.numpy(), np.asarray(visits_j))
    assert torch.equal(flags, (visits > 0).to(torch.int32))
    assert all(torch.equal(x, y) for x, y in zip(res, flagged))
    # A caller's start wins: the root start gives the no-table trace.
    root = (torch.zeros(n, dtype=torch.int32), torch.zeros(n, 3), torch.zeros(n, dtype=torch.int32))
    a = ttracer.trace(wt, _t(origins), _t(flat), start=root, **kw)
    b = ttracer.trace(wt, _t(origins), _t(flat), parent_restart=restart)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("restart", [True, False], ids=["parent", "root"])
def test_trace_shadow_table_first_descent_only_equals_jax(restart):
    """``trace_shadow(warp_in_body=False)``: the shadow rays of a primary
    result (``shadow_rays``'s, back faces culled) traced with the combined
    table read for first descents only, as JAX's frame traces them
    (``trace_staged`` with ``warp_in_body=False``): the hit mask equal to
    JAX's, and the visit counts to JAX ``trace`` started at the table's
    cells, exactly."""
    words, tab = _words("random6"), _table("random6")
    o, d = _rays("bench")
    n = RES * RES
    wt, tt = state.u32_to_device(words, "cpu"), state.table_to_device(tab, "cpu")
    prim = ttracer.trace(wt, _t(o).reshape(1, 3).expand(n, 3), _t(d).reshape(-1, 3))
    so, sd, active = ttracer.shadow_rays(prim)
    assert int(active.sum()) > 0
    res_j, _ = jtracer.trace_staged(jnp.asarray(words), jnp.asarray(so.numpy()),
                                    jnp.asarray(sd.numpy()), active_init=jnp.asarray(active),
                                    warp_table=jnp.asarray(tab), parent_restart=restart)
    start = ttracer._warp_start(tt, so, sd, True)
    _, visits_j = jtracer.trace(jnp.asarray(words), jnp.asarray(so.numpy()),
                                jnp.asarray(sd.numpy()), jnp.asarray(active),
                                start=tuple(jnp.asarray(s.numpy()) for s in start),
                                with_visits=True, parent_restart=restart)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    hit = ttracer.trace_shadow(wt, prim, warp_table=tt, visits=visits, parent_restart=restart,
                               image_width=0, warp_in_body=False)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(res_j.hit))
    np.testing.assert_array_equal(visits.numpy(), np.asarray(visits_j))
    assert bool(hit.any())


# -- compaction ranks and patch padding --------------------------------------


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 70_000])
def test_fast_ranks_and_nonzero_equal_jax(n):
    rng = np.random.default_rng(n)
    for p in (0.0, 0.03, 0.5, 1.0):
        mask = rng.random(n) < p
        ranks = ttracer.fast_ranks(_t(mask))
        np.testing.assert_array_equal(ranks.numpy(),
                                      np.asarray(jtracer.fast_ranks(jnp.asarray(mask))))
        for size, fill in ((max(1, n // 7), n), (n + 5, -1)):
            got = ttracer.fast_nonzero(_t(mask), size, fill)
            want = np.asarray(jtracer.fast_nonzero(jnp.asarray(mask), size, fill))
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                feedback.fast_nonzero(_t(mask), size, fill, ranks=ranks).numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 256, 257, 4096, 5000])
def test_pad_patches_equals_jax(n):
    rng = np.random.default_rng(n)
    idx = rng.integers(0, 1 << 20, n).astype(np.int32)
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    for buckets in ((256, 4096, 65536, 1048576), (300, 5000)):
        got, want = feedback.pad_patches(idx, vals, buckets), jfeedback.pad_patches(
            idx, vals, buckets)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert adaptive.pad_patches is feedback.pad_patches
    if n:  # past the last bucket
        with pytest.raises(ValueError):
            feedback.pad_patches(idx, vals, (n - 1,))
        with pytest.raises(ValueError):
            jfeedback.pad_patches(idx, vals, (n - 1,))


def test_pool_size_constants_equal_jax():
    assert ttracer.BIG_POOL_WORDS == jtracer.BIG_POOL_WORDS
    assert ttracer.PACK_POOL_WORDS == jtracer.PACK_POOL_WORDS


# -- JAX's errors for schedule combinations --------------------------------

_FRAME_ERRORS = {
    "tiled table": dict(mode="tiled", warp_table=True),
    "tiled flags": dict(mode="tiled", with_visits=True, visit_flags=True),
    "tiled pre_permuted": dict(mode="tiled", pre_permuted=True),
    "staged pre_permuted": dict(mode="staged", pre_permuted=True),
    "pre_permuted morton": dict(mode="beam", pre_permuted=True, beam_iters=(16, 8)),
    "tiled paged": dict(mode="tiled", paged=True),
    "staged paged visits": dict(mode="staged", paged=True, with_visits=True),
    "beam paged show_hits": dict(mode="beam", paged=True, show_hits=True),
    "shadow_seed visits": dict(mode="staged", shadow_seed=True, with_visits=True),
    "beam block": dict(mode="beam", beams=12),
    "staged max_steps": dict(mode="staged", max_steps=1024),
    "beam max_steps": dict(mode="beam", max_steps=128),
    "staged pack_pool bricks": dict(mode="staged", pack_pool=True, bricks=True),
}


@pytest.mark.parametrize("case", sorted(_FRAME_ERRORS))
def test_render_frame_raises_jax_errors(case):
    """JAX ``render_frame`` raises ``ValueError`` for the combination, and
    so does the port's."""
    kw = dict(_FRAME_ERRORS[case])
    words = _words("shell5")
    o, d = _rays("bench")
    wt = state.u32_to_device(words, "cpu")
    jw = jnp.asarray(words)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("warp_table", None):
        jkw["warp_table"] = jnp.asarray(_table("shell5"))
        tkw["warp_table"] = state.table_to_device(_table("shell5"), "cpu")
    if kw.get("paged"):
        from octree_tracer_tpu.render import paging as jpaging
        from octree_tracer_tpu_torch.render import paging
        pp, jpp = paging.build_pages(words), jpaging.build_pages(words)
        jw, wt = jnp.asarray(jpp.words), state.u32_to_device(pp.words, "cpu")
        jkw["paged"] = (jpp.top_rows, jpp.page_rows, jpp.n_pages)
        tkw["paged"] = (pp.top_rows, pp.page_rows, pp.n_pages)
    if kw.get("bricks"):
        from octree_tracer_tpu_torch.render import bricks
        dec, br = bricks.build_bricks(wt)
        wt, tkw["bricks"] = dec, br
        jw, jkw["bricks"] = (jnp.asarray(state.to_numpy_u32(dec)),
                             jnp.asarray(state.to_numpy_u32(br)))
    with pytest.raises(ValueError):
        jtracer.render_frame(jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(jtracer.DEFAULT_SUN),
                             **jkw)
    with pytest.raises(ValueError):
        ttracer.render_frame(wt, _t(o), _t(d), **tkw)


_STAGED_ERRORS = {
    "max_steps": dict(max_steps=1024),
    "slim aux": dict(slim_result=True, beam_aux=True),
    "beam_shape size": dict(beam_shape=(RES, RES // 2, 8)),
    "beam_shape block": dict(beam_shape=(RES, RES, 12)),
    "beam_shape start": dict(beam_shape=(RES, RES, 8), start=True),
    "beam_shape entry_width": dict(beam_shape=(RES, RES, 8), entry_width=64),
    "beam max_steps": dict(beam_shape=(RES, RES, 8), max_steps=128),
}


@pytest.mark.parametrize("case", sorted(_STAGED_ERRORS))
def test_trace_staged_raises_jax_errors(case):
    kw = dict(_STAGED_ERRORS[case])
    words = _words("shell5")
    o, d = _rays("bench")
    n = RES * RES
    origins, flat = np.broadcast_to(o, (n, 3)).copy(), d.reshape(-1, 3)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("start"):
        (ji, jp, jd), _ = jtracer.beam_start(jnp.asarray(words), jnp.asarray(o), jnp.asarray(d),
                                             block=8)
        jkw["start"], tkw["start"] = (ji, jp, jd), (_t(ji), _t(jp), _t(jd))
    with pytest.raises(ValueError):
        jtracer.trace_staged(jnp.asarray(words), jnp.asarray(origins), jnp.asarray(flat), **jkw)
    with pytest.raises(ValueError):
        ttracer.trace_staged(state.u32_to_device(words, "cpu"), _t(origins), _t(flat), **tkw)


def test_render_frame_schedule_needs_a_mode():
    """The port's own frame (``mode=None``) takes none of the arguments
    that change a result, and names an unknown mode."""
    words = state.u32_to_device(_words("shell5"), "cpu")
    o, d = _rays("bench")
    for kw in (dict(beams=8), dict(raw_result=True), dict(pre_permuted=True),
               dict(warp_in_body=False), dict(mode="lockstep"), dict(tile_size=0)):
        with pytest.raises(ValueError):
            ttracer.render_frame(words, _t(o), _t(d), **kw)
    tab = state.table_to_device(_table("shell5"), "cpu")
    with pytest.raises(ValueError):
        ttracer.render_frame(words, _t(o), _t(d), warp_table=tab, warp_levels=LEVELS - 1)


def test_beams_that_do_not_divide_are_ignored():
    """JAX runs the beam pre-pass in the tiled and staged modes only when
    the block divides both sides (tracer.py:3387); otherwise the frame is
    the one without ``beams``, visits included."""
    words = state.u32_to_device(_words("random6"), "cpu")
    o, d = _rays("inside")
    for mode in ("tiled", "staged"):
        base = ttracer.render_frame(words, _t(o), _t(d), mode=mode, with_visits=True)
        odd = ttracer.render_frame(words, _t(o), _t(d), mode=mode, with_visits=True, beams=12)
        assert torch.equal(odd[0], base[0]) and torch.equal(odd[2], base[2])
        assert all(torch.equal(a, b) for a, b in zip(odd[1], base[1]))
        with_beams = ttracer.render_frame(words, _t(o), _t(d), mode=mode, with_visits=True,
                                          beams=8)
        assert not torch.equal(with_beams[2], base[2])
