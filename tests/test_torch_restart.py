"""Kernel K1's root-restart form (``parent_restart=False``): the port's
``trace`` (on the CPU, its plain version) against JAX ``trace`` and the
NumPy oracle, and against the port's own parent-restart form.

Under ``parent_restart=False`` a ray descends again after every boundary
step, from the warp cell's stored node where the table has one, else from
the root: the reference's full re-descent (src/shader.wgsl:213-245), the
only form whose visit counts have the reference counter's magnitudes.

- Against JAX ``trace(parent_restart=False)``: every field and every visit
  count equal (hit_pos within the repository's 1e-5: JAX's CPU build
  contracts the position update otherwise, an ulp). Under a table the rays
  start inside the root cube, as in ``test_torch_visits.py``: from outside,
  JAX's CPU build rounds a ray's entry point on the cube's face an ulp
  inside, so it resumes some rays at their warp cell where the port starts
  them at the root. Under the combined table a counted jump also marks the
  empty leaves of the cells it crosses, which JAX's leaves unread
  (``jump_marks``): there the counts are JAX's but on empty leaves, the
  steps are a root descent's, and the closed zero-set is the plain
  reference's.
- Against the oracle, which always re-descends from the root: counts equal
  on the analytic scene of ``tests/test_tracer.py:145-163``.
- Against the parent form: every field bit for bit, filled-leaf counts and
  the interior zero-set equal (``tests/test_tracer.py:103``, ``:126``,
  ``:331``).

Scenes stay at 12 levels or fewer, where JAX's CPU ``1 / exp2(d)`` is exact
(ROADMAP §3); the cyclic pool is held to the oracle.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jump_marks import (assert_jax_marks_with_jumps, assert_reference_zero_set,
                        reference_visits, skip_free)

from octree_tracer_tpu.core import CpuOctree as JCpuOctree
from octree_tracer_tpu.core import pack_rgb as jpack_rgb
from octree_tracer_tpu.render import cpu_reference as joracle
from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.adaptive import feedback
from octree_tracer_tpu_torch.core import CpuOctree, pack_rgb
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET
from octree_tracer_tpu_torch.render import cpu_reference as toracle
from octree_tracer_tpu_torch.render import tracer as ttracer

RES = 32
LEVELS = 4
EXACT = ("hit", "forced", "index", "steps", "depth", "normal", "word")
CAMERAS = {
    "bench": (np.array([0.4, 0.6, -2.2], np.float32),
              np.array([-0.2, -0.35, 1.0], np.float32)),
    # inside the root cube: rays start at the camera, no entry point
    "inside1": (np.array([0.2, 0.3, -0.9], np.float32),
                np.array([-0.1, -0.15, 1.0], np.float32)),
    "inside2": (np.array([-0.35, 0.55, -0.6], np.float32),
                np.array([0.3, -0.5, 1.0], np.float32)),
}
SCENES = {
    "shell5": lambda: scenes.deep_shell(5),
    "random6": lambda: scenes.random_scene(6, 1500, 3),
}
INSIDE = {"shell5": "inside1", "random6": "inside2"}


@functools.lru_cache(maxsize=None)
def _words(scene):
    return SCENES[scene]()


@functools.lru_cache(maxsize=None)
def _table(scene, kind):
    if kind == "none":
        return None
    words = jnp.asarray(_words(scene))
    if kind == "warp":
        return np.asarray(jtracer.build_warp_table(words, LEVELS))
    return np.asarray(jskip.build_warp_skip_table(words, LEVELS))


@functools.lru_cache(maxsize=None)
def _rays(cam, res=RES):
    pos, look = CAMERAS[cam]
    _, ci = camera_matrices(pos, look, 70.0, res, res)
    o, d = generate_rays(ci, res, res)
    d = np.asarray(d)
    flat = d.reshape(-1, 3)
    return np.asarray(o), d, np.broadcast_to(np.asarray(o), flat.shape).copy(), flat


def _kinds(words):
    payload = words >> np.uint32(4)
    filled = payload > VOXEL_OFFSET
    interior = (payload < VOXEL_OFFSET) & (words != 0)
    return filled, interior


def _port(words, origins, dirs, tab=None, visits=None, **kw):
    res = ttracer.trace(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origins), torch.from_numpy(dirs),
        warp_table=None if tab is None else state.table_to_device(tab, "cpu"), visits=visits,
        **kw)
    return ttracer.to_numpy(res)


def _jax(words, origins, dirs, tab=None, **kw):
    res, visits = jtracer.trace(
        jnp.asarray(words), jnp.asarray(origins), jnp.asarray(dirs),
        warp_table=None if tab is None else jnp.asarray(tab), **kw)
    return ttracer.to_numpy(res), (None if visits is None else np.asarray(visits))


def _assert_exact(a, b):
    for f in EXACT:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert np.abs(a["hit_pos"] - b["hit_pos"]).max() <= 1e-5


@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
@pytest.mark.parametrize("strict", [True, False], ids=["strict", "ge"])
@pytest.mark.parametrize("table", ["none", "warp", "combined"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_root_restart_equals_jax(scene, table, strict, flags):
    """Every field and every visit mark equal to JAX ``trace(parent_restart=
    False, with_visits=True)``: no table, a warp table and a combined table
    (but its jumps' marks of empty leaves and steps, the module docstring),
    strict and ``>=`` descent, counts and flags."""
    words, tab = _words(scene), _table(scene, table)
    _, _, origins, dirs = _rays(INSIDE[scene])
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, origins, dirs, tab, visits, strict_descent=strict, visit_flags=flags,
              parent_restart=False)
    b, expect = _jax(words, origins, dirs, tab, strict_descent=strict, with_visits=True,
                     visit_flags=flags, parent_restart=False)
    if table == "combined":
        b["steps"] = _jax(words, origins, dirs, skip_free(tab), strict_descent=strict,
                          parent_restart=False)[0]["steps"]
    _assert_exact(a, b)
    if table == "combined":
        assert_jax_marks_with_jumps(words, visits.numpy(), expect)
        assert_reference_zero_set(words, visits.numpy(),
                                  reference_visits(words, origins, dirs),
                                  filled_counts=not flags)
    else:
        np.testing.assert_array_equal(visits.numpy(), expect)
    assert a["hit"].any() and visits.sum() > 0


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_root_restart_outside_camera_equals_jax(scene):
    """From a camera outside the root cube, without a table: JAX's and the
    port's entry points agree there, so counts are exact too."""
    words = _words(scene)
    _, _, origins, dirs = _rays("bench")
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, origins, dirs, visits=visits, parent_restart=False)
    b, expect = _jax(words, origins, dirs, with_visits=True, parent_restart=False)
    _assert_exact(a, b)
    np.testing.assert_array_equal(visits.numpy(), expect)


def _analytic_scene(octree_cls, rgb):
    """tests/test_tracer.py:145-163: two voxels at depth 2 and three axis
    rays, no knife edge."""
    t = octree_cls(0)
    t.put_in_voxel([0.5, 0.5, 0.5], rgb(10, 20, 30), 2)
    t.put_in_voxel([-0.5, -0.5, -0.5], rgb(40, 50, 60), 2)
    origins = np.array([[0.55, 0.55, -3.0], [-0.55, -0.55, -3.0], [0.2, -0.6, -3.0]],
                       dtype=np.float32)
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (3, 1))
    return t.to_words(), origins, dirs


def test_root_restart_visits_equal_oracle_analytic():
    """The analytic scene of tests/test_tracer.py:145-163: the root form's
    counts equal the oracle's exactly (JAX's and the port's copy), and the
    parent form's do not (it re-descends fewer levels)."""
    words, origins, dirs = _analytic_scene(CpuOctree, pack_rgb)
    words_j, _, _ = _analytic_scene(JCpuOctree, jpack_rgb)
    np.testing.assert_array_equal(words, words_j)
    want = np.zeros(words.shape[0], dtype=np.int64)
    res_o = joracle.trace_rays(words, origins, dirs, visits=want)
    want_t = np.zeros_like(want)
    toracle.trace_rays(words, origins, dirs, visits=want_t)
    np.testing.assert_array_equal(want_t, want)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, origins, dirs, visits=visits, parent_restart=False)
    np.testing.assert_array_equal(visits.numpy(), want)
    for f in ("hit", "index", "steps", "depth", "normal", "hit_pos"):
        np.testing.assert_array_equal(a[f], res_o[f], err_msg=f)
    parent = torch.zeros_like(visits)
    _port(words, origins, dirs, visits=parent)
    assert a["hit"].any() and parent.sum() < visits.sum()


@pytest.mark.parametrize("scene,cam", [("shell5", "bench"), ("random6", "bench"),
                                       ("random6", "inside2")])
def test_root_restart_visits_equal_oracle(scene, cam):
    """On a whole frame without a table: the root form's counts equal the
    port's oracle's on every slot, as its hits do."""
    words = _words(scene)
    origin, _, origins, dirs = _rays(cam)
    want = np.zeros(words.shape[0], dtype=np.int64)
    res_o = toracle.trace_rays(words, origin, dirs, visits=want)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, origins, dirs, visits=visits, parent_restart=False)
    np.testing.assert_array_equal(visits.numpy(), want)
    for f in ("hit", "index", "steps", "depth", "normal"):
        np.testing.assert_array_equal(a[f], res_o[f], err_msg=f)


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "ge"])
@pytest.mark.parametrize("table", ["none", "warp", "combined"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_root_and_parent_forms_agree(scene, table, strict):
    """The two forms in the port: every field bit for bit, the filled-leaf
    counts and the interior zero-set equal; without a table the root form
    marks more interior visits. Under a table both forms resume at warp
    cells, whose ancestors neither marks, and from a leaf above the table's
    depth the parent form re-descends only its parent; the zero-set is then
    compared after the visit closure that the Session runs before it selects
    (``feedback.propagate_visits``), as in ``test_torch_visits.py``."""
    words, tab = _words(scene), _table(scene, table)
    _, _, origins, dirs = _rays("bench")
    marks = {}
    for restart in (False, True):
        v = torch.zeros(words.shape[0], dtype=torch.int32)
        out = _port(words, origins, dirs, tab, v, strict_descent=strict,
                    parent_restart=restart)
        marks[restart] = (out, v.numpy())
    (a, va), (b, vb) = marks[False], marks[True]
    for f in EXACT + ("hit_pos",):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    filled, interior = _kinds(words)
    np.testing.assert_array_equal(va[filled], vb[filled])
    if tab is None:
        assert va[interior].sum() > vb[interior].sum()
    else:
        w = state.u32_to_device(words, "cpu")
        passes = 7  # random6 and shell5: leaves at depth 6 or less
        va, vb = (feedback.propagate_visits(w, torch.from_numpy(v), passes).numpy()
                  for v in (va, vb))
    np.testing.assert_array_equal(va[interior] == 0, vb[interior] == 0)


def test_trace_shadow_root_restart_equals_jax():
    """K1's shadow mode in the root form: its hit mask and counts are JAX
    ``trace(parent_restart=False)``'s on the shadow rays built in NumPy,
    with the jumps' marks of empty leaves (the module docstring), whose
    closure leaves the interior zero-set and filled-leaf counts of the
    reference's trace of those rays."""
    words, tab = _words("random6"), _table("random6", "combined")
    _, d_img, origins, _ = _rays("inside2")
    w, t = state.u32_to_device(words, "cpu"), state.table_to_device(tab, "cpu")
    res = ttracer.trace(w, torch.from_numpy(origins), torch.from_numpy(d_img), warp_table=t,
                        parent_restart=False)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    hit = ttracer.trace_shadow(w, res, cull=False, warp_table=t, visits=visits,
                               parent_restart=False, image_width=RES)
    neg_sun = ttracer._neg_sun(ttracer.DEFAULT_SUN)
    o_np = res.hit_pos.numpy() + res.normal.numpy() * np.float32(2.5e-6)
    d_np = np.broadcast_to(neg_sun, o_np.shape).copy()
    jres, expect = _jax(words, o_np, d_np, tab, active_init=jnp.asarray(res.hit.numpy()),
                        with_visits=True, parent_restart=False)
    np.testing.assert_array_equal(hit.numpy(), jres["hit"])
    assert_jax_marks_with_jumps(words, visits.numpy(), expect)
    on = res.hit.numpy()
    assert_reference_zero_set(words, visits.numpy(), reference_visits(words, o_np[on], d_np[on]))
    assert hit.any() and (res.hit & ~hit).any()


def _port_frame(words, tab, origin, d_img, **kw):
    return ttracer.render_frame(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origin), torch.from_numpy(d_img),
        warp_table=None if tab is None else state.table_to_device(tab, "cpu"),
        parent_restart=False, **kw)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_frame_root_restart_equals_jax_trace_path(scene):
    """Held exactly where JAX's frame reduces to ``trace``: ``tile_size=
    None``, no table, counts (JAX's tiled frame takes no table and no flags,
    and does not cull the shadow rays, as the port's counted frame does not).
    Visits equal on every slot, the result on every field, the f32 image
    within 1e-6 (XLA's CPU ``pow`` rounds otherwise than PyTorch's by an
    ulp, which a 32x32 u8 frame can show on more than 0.1% of channels)."""
    words = _words(scene)
    origin, d_img, _, _ = _rays("bench")
    img, res, visits = _port_frame(words, None, origin, d_img, with_visits=True)
    img_j, res_j, visits_j = jtracer.render_frame(
        jnp.asarray(words), jnp.asarray(origin), jnp.asarray(d_img),
        jnp.asarray(jtracer.DEFAULT_SUN), with_visits=True, tile_size=None,
        parent_restart=False)
    np.testing.assert_array_equal(visits.numpy(), np.asarray(visits_j))
    _assert_exact(ttracer.to_numpy(res), ttracer.to_numpy(res_j))
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
@pytest.mark.parametrize("mode,table,cam", [("staged", "combined", "inside2"),
                                            ("beam", "none", "bench")])
def test_render_frame_root_restart_matches_jax_modes(mode, table, cam, flags):
    """Counts and flags against JAX's staged and beam frames (its tiled frame
    takes neither a table nor flags). The staged frame re-descends per ray as
    ``trace`` does, so it is held exactly: every visit, with the combined
    table, from inside the root cube, but the jumps' marks of empty leaves
    and steps (the module docstring). The beam frame shares a block's
    descent and counts its shared visits by the block (tracer.py:1242-1253),
    so interior magnitudes differ by design: it is held to the two
    invariants that the LOD thresholds read, filled-leaf counts exact and
    the interior zero-set exact. Hit fields equal, the f32 image within 1e-6
    (XLA's CPU ``pow``)."""
    words, tab = _words("random6"), _table("random6", table)
    origin, d_img, _, _ = _rays(cam)
    img, res, visits = _port_frame(words, tab, origin, d_img, with_visits=True,
                                   visit_flags=flags)
    img_j, res_j, visits_j = jtracer.render_frame(
        jnp.asarray(words), jnp.asarray(origin), jnp.asarray(d_img),
        jnp.asarray(jtracer.DEFAULT_SUN), with_visits=True, visit_flags=flags,
        mode=mode, parent_restart=False,
        warp_table=None if tab is None else jnp.asarray(tab))
    b = ttracer.to_numpy(res_j)
    if tab is not None:
        b["steps"] = ttracer.to_numpy(jtracer.render_frame(
            jnp.asarray(words), jnp.asarray(origin), jnp.asarray(d_img),
            jnp.asarray(jtracer.DEFAULT_SUN), mode=mode, parent_restart=False,
            warp_table=jnp.asarray(skip_free(tab)))[1])["steps"]
    _assert_exact(ttracer.to_numpy(res), b)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=1e-6, atol=1e-7)
    v, vj = visits.numpy(), np.asarray(visits_j)
    if mode == "staged":
        assert_jax_marks_with_jumps(words, v, vj)
    filled, interior = _kinds(words)
    np.testing.assert_array_equal(v[filled], vj[filled])
    np.testing.assert_array_equal(v[interior] == 0, vj[interior] == 0)
    assert v[filled].sum() > 0 and (v[interior] == 0).any() and (v[interior] > 0).any()


def test_render_frame_visit_modes_agree_in_root_form():
    """Flags with the filled-leaf overlay (``overlay_hit_counts``) against
    exact counts, both in the root form: filled-leaf counts and the interior
    zero-set equal; the images equal the uncounted parent-form frame's."""
    words, tab = _words("shell5"), _table("shell5", "combined")
    origin, d_img, _, _ = _rays("bench")
    img0, _, _ = ttracer.render_frame(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origin), torch.from_numpy(d_img),
        warp_table=state.table_to_device(tab, "cpu"), u8_image=True)
    img_c, _, counts = _port_frame(words, tab, origin, d_img, with_visits=True, u8_image=True)
    img_f, _, marks = _port_frame(words, tab, origin, d_img, with_visits=True,
                                  visit_flags=True, u8_image=True)
    np.testing.assert_array_equal(img_c.numpy(), img0.numpy())
    np.testing.assert_array_equal(img_f.numpy(), img0.numpy())
    filled, interior = _kinds(words)
    c, f = counts.numpy(), marks.numpy()
    np.testing.assert_array_equal(c[filled], f[filled])
    np.testing.assert_array_equal(c[interior] == 0, f[interior] == 0)


@pytest.mark.parametrize("restart", [False, True], ids=["root", "parent"])
@pytest.mark.parametrize("table", ["none", "combined"])
def test_max_iters_leaves_jax_rays_unresolved(table, restart):
    """A trip cap below what the rays need: the same rays stay unresolved
    (no hit, index -1, steps and depth 0) as under JAX's ``max_iters``, and
    every field is equal."""
    words, tab = _words("random6"), _table("random6", table)
    _, _, origins, dirs = _rays("inside2")
    a = _port(words, origins, dirs, tab, parent_restart=restart, max_iters=30)
    b, _ = _jax(words, origins, dirs, tab, parent_restart=restart, max_iters=30)
    _assert_exact(a, b)
    full = _port(words, origins, dirs, tab, parent_restart=restart)
    cut = full["hit"] & ~a["hit"]
    assert cut.any() and a["hit"].any()
    assert (a["index"][cut] == -1).all() and (a["steps"][cut] == 0).all()


def test_max_iters_rejects_out_of_range():
    words = _words("shell5")
    _, _, origins, dirs = _rays("bench")
    for bad in (-1, 1 << 31):
        with pytest.raises(ValueError):
            _port(words, origins, dirs, max_iters=bad)


MALFORMED = {k: v for k, v in scenes.malformed_pools().items() if k != "self_cycle"}


@pytest.mark.parametrize("table", ["none", "combined"])
@pytest.mark.parametrize("pool", sorted(MALFORMED))
def test_malformed_pool_root_restart_equals_jax(pool, table):
    """Pointers past the pool's end, in the root form: the clamped row reads
    and the dropped marks of JAX's row gather and scatter, every field and
    count equal to JAX's, but the combined table's jump marks of empty
    leaves and steps (the module docstring)."""
    words = MALFORMED[pool]
    tab = None if table == "none" else np.asarray(
        jskip.build_warp_skip_table(jnp.asarray(words), 3))
    _, _, origins, dirs = _rays("inside2", 24)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, origins, dirs, tab, visits, parent_restart=False)
    b, expect = _jax(words, origins, dirs, tab, with_visits=True, parent_restart=False)
    if tab is not None:
        b["steps"] = _jax(words, origins, dirs, skip_free(tab), parent_restart=False)[0]["steps"]
    _assert_exact(a, b)
    if tab is None:
        np.testing.assert_array_equal(visits.numpy(), expect)
    else:
        assert_jax_marks_with_jumps(words, visits.numpy(), expect)
    assert a["hit"].any() and (a["index"] >= words.shape[0]).any()


def _cycle_rays(n=384, seed=1):
    """As tests/test_torch_trace.py: random rays, half from outside the root
    cube, about half of them with one axis of origin and direction 0."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    origins[: n // 2] *= np.float32(2.5)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    on_plane = rng.random(n) < 0.5
    origins[on_plane, axis[on_plane]] = 0.0
    dirs[on_plane, axis[on_plane]] = 0.0
    return origins, dirs


def test_self_cycle_pool_root_restart_equals_oracle():
    """The pool whose pointers cycle, in the root form: every output and
    every count equal to the oracle's (which always re-descends from the
    root); rays on a centre plane run to the loop's cap past 126 levels.
    The parent form gives the same results."""
    words = scenes.malformed_pools()["self_cycle"]
    origins, dirs = _cycle_rays()
    want = np.zeros(words.shape[0], dtype=np.int64)
    with np.errstate(over="ignore", divide="ignore"):  # exp2(d) overflows from d = 128
        b = toracle.trace_rays(words, origins, dirs, visits=want)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, origins, dirs, visits=visits, parent_restart=False)
    for f in ("hit", "forced", "index", "steps", "depth", "normal", "hit_pos"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_array_equal(visits.numpy(), want)
    parent = _port(words, origins, dirs)
    for f in EXACT + ("hit_pos",):
        np.testing.assert_array_equal(a[f], parent[f], err_msg=f)
    inside = np.all(np.abs(origins) < 1.0, axis=1)
    enters = inside | (toracle._ray_box_dist(origins, dirs) > 0)
    assert a["hit"].sum() > 50 and (enters & ~a["hit"]).sum() > 50
