"""Visit counting: the port's ``trace`` with ``visits`` (on the CPU, the plain
version of kernel K1's marking) and ``render_frame`` with ``with_visits``,
``visit_flags`` and ``show_hits`` (K1 and K4's hit-counter view) against the
JAX package on the same NumPy inputs.

``trace`` counts are held exactly equal to JAX ``trace(with_visits=True)``,
flags to its ``visit_flags`` marks: integer marks in the same loop trips.
From a camera outside the root cube that holds without a table. Under a
warp table it holds from cameras inside the cube: JAX's CPU build rounds a
ray's entry point on the cube's face differently (an ulp inside the face,
where the port and NumPy land on it), so JAX starts some rays at their warp
cell where the port starts them at the root. Hits agree; only interior
magnitudes differ, and the marked set is equal.
JAX's beam ``render_frame`` counts magnitudes differently by design
(tracer.py:3242-3253), so frame visits are held to the two invariants the LOD
thresholds read: filled-leaf counts exact, and the set of interiors with no
visit exact. The u8 images are equal.

Under a combined table a counted skip jump also marks the empty leaf of each
cell it crosses, which JAX's jump leaves unread (``jump_marks``): there the
marks are held to JAX's on every slot but empty leaves, and the closed
interior zero-set to the plain reference's root descent.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jump_marks import assert_jax_marks_with_jumps, assert_reference_zero_set, reference_visits

from octree_tracer_tpu.adaptive import feedback as jfeedback
from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.adaptive import feedback
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET
from octree_tracer_tpu_torch.render import tracer as ttracer

RES = 48
LEVELS = 4
CAMERAS = {
    "bench": (np.array([0.4, 0.6, -2.2], np.float32),
              np.array([-0.2, -0.35, 1.0], np.float32)),
    "deep10": (np.array([0.2, 0.3, -2.4], np.float32),
               np.array([-0.1, -0.15, 1.0], np.float32)),
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


def _camera(cam):
    pos, look = CAMERAS[cam]
    _, ci = camera_matrices(pos, look, 70.0, RES, RES)
    return generate_rays(ci, RES, RES)


def _kinds(words):
    payload = words >> np.uint32(4)
    filled = payload > VOXEL_OFFSET
    interior = (payload < VOXEL_OFFSET) & (words != 0)
    return filled, interior


def _trace_both(scene, cam, table, flags):
    words, tab = _words(scene), _table(scene, table)
    origin, dirs = _camera(cam)
    flat = dirs.reshape(-1, 3)
    origins = np.broadcast_to(origin, flat.shape).copy()
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    res = ttracer.trace(state.u32_to_device(words, "cpu"), torch.from_numpy(origins),
                        torch.from_numpy(flat), visits=visits, visit_flags=flags,
                        warp_table=None if tab is None else state.table_to_device(tab, "cpu"))
    res_j, visits_j = jtracer.trace(
        jnp.asarray(words), jnp.asarray(origins), jnp.asarray(flat), with_visits=True,
        visit_flags=flags, warp_table=None if tab is None else jnp.asarray(tab))
    np.testing.assert_array_equal(ttracer.to_numpy(res)["index"], np.asarray(res_j.index))
    assert visits.sum() > 0
    if flags:
        assert set(np.unique(visits.numpy())) <= {0, 1}
    return words, visits.numpy(), np.asarray(visits_j)


def _assert_combined_marks(scene, cam, v, vj, flags, exact):
    """Under the combined table: JAX's marks but on empty leaves, and the
    reference's zero-set (and filled-leaf counts) of the same rays."""
    words = _words(scene)
    assert_jax_marks_with_jumps(words, v, vj, exact)
    origin, dirs = _camera(cam)
    assert_reference_zero_set(words, v, reference_visits(words, origin, dirs),
                              filled_counts=not flags)


@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
@pytest.mark.parametrize("table", ["none", "warp", "combined"])
@pytest.mark.parametrize("scene,cam", [("shell5", "inside1"), ("random6", "inside2")])
def test_trace_visits_equal_jax(scene, cam, table, flags):
    _, v, vj = _trace_both(scene, cam, table, flags)
    if table == "combined":
        _assert_combined_marks(scene, cam, v, vj, flags, exact=True)
    else:
        np.testing.assert_array_equal(v, vj)


@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
@pytest.mark.parametrize("table", ["none", "warp", "combined"])
@pytest.mark.parametrize("scene,cam", [("shell5", "deep10"), ("random6", "bench")])
def test_trace_visits_outside_camera_match_jax(scene, cam, table, flags):
    """Exact without a table and in flag mode; under a table the counts'
    marked set and filled-leaf counts are exact (see the module docstring)."""
    words, v, vj = _trace_both(scene, cam, table, flags)
    filled, _ = _kinds(words)
    np.testing.assert_array_equal(v[filled], vj[filled])
    if table == "combined":
        _assert_combined_marks(scene, cam, v, vj, flags, exact=flags)
        return
    if table == "none" or flags:
        np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(v > 0, vj > 0)


def test_trace_visits_accumulate_and_flags_are_counts_nonzero():
    """Marks add into the array the caller passes; flag mode marks exactly
    the slots that count mode counts."""
    words = _words("random6")
    origin, dirs = _camera("bench")
    flat = torch.from_numpy(dirs.reshape(-1, 3))
    origins = torch.from_numpy(np.broadcast_to(origin, dirs.reshape(-1, 3).shape).copy())
    w = state.u32_to_device(words, "cpu")
    counts = torch.zeros(words.shape[0], dtype=torch.int32)
    ttracer.trace(w, origins, flat, visits=counts)
    flags = torch.zeros_like(counts)
    ttracer.trace(w, origins, flat, visits=flags, visit_flags=True)
    np.testing.assert_array_equal(flags.numpy(), (counts > 0).numpy().astype(np.int32))
    twice = counts.clone()
    ttracer.trace(w, origins, flat, visits=twice)
    np.testing.assert_array_equal(twice.numpy(), 2 * counts.numpy())


def _port_frame(words, tab, origin, dirs, **kw):
    return ttracer.render_frame(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origin),
        torch.from_numpy(dirs), u8_image=True,
        warp_table=None if tab is None else state.table_to_device(tab, "cpu"), **kw)


@pytest.mark.parametrize("mode,table", [("flags", "combined"), ("counts", "none"),
                                        ("show_hits", "none")])
def test_render_frame_visits_match_jax(mode, table):
    """A frame that rides a table under-marks shallow interiors in both
    packages, and differently (entry points, see the module docstring);
    the Session closes such visits with ``propagate_visits`` before it
    selects, so the zero-set is compared after the closure there.

    The show_hits grey is ``(k/15)^2.2``, whose u8 encode truncates values
    within an ulp of the integers ``17k``: the two ``pow`` implementations
    can land on either side. That view is compared in f32, within 1e-6."""
    words, tab = _words("shell5"), _table("shell5", table)
    origin, dirs = _camera("deep10")
    kw = {"flags": dict(with_visits=True, visit_flags=True),
          "counts": dict(with_visits=True),
          "show_hits": dict(show_hits=True)}[mode]
    u8 = mode != "show_hits"
    img, res, visits = ttracer.render_frame(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origin),
        torch.from_numpy(dirs), u8_image=u8,
        warp_table=None if tab is None else state.table_to_device(tab, "cpu"), **kw)
    img_j, _, visits_j = jtracer.render_frame(
        jnp.asarray(words), jnp.asarray(origin), jnp.asarray(dirs),
        jnp.asarray(jtracer.DEFAULT_SUN), shadows=True, mode="beam", u8_image=u8,
        warp_table=None if tab is None else jnp.asarray(tab), **kw)
    if u8:
        np.testing.assert_array_equal(img.numpy(), np.asarray(img_j))
    else:
        np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=1e-6, atol=0)
        assert len(np.unique(img.numpy())) > 2
    v, vj = visits.numpy(), np.asarray(visits_j)
    filled, interior = _kinds(words)
    if tab is not None:
        # The closure leaves the reference frame's zero-set, inside JAX's,
        # whose jumps leave interiors unread (the module docstring).
        passes = 6  # shell5: leaves at depth 5
        ref = reference_visits(words, origin, dirs, shadows=True)
        assert_reference_zero_set(words, v, ref, passes)
        v = feedback.propagate_visits(state.u32_to_device(words, "cpu"), visits,
                                      passes).numpy()
        vj = np.asarray(jfeedback.propagate_visits(jnp.asarray(words), visits_j,
                                                   passes=passes))
        np.testing.assert_array_equal(v[filled], vj[filled])
        assert ((vj[interior] == 0) >= (v[interior] == 0)).all()
    else:
        np.testing.assert_array_equal(v[filled], vj[filled])
        np.testing.assert_array_equal(v[interior] == 0, vj[interior] == 0)
    assert v[filled].sum() > 0 and (v[interior] == 0).any() and (v[interior] > 0).any()


def test_render_frame_visit_modes_agree():
    """Flags with the filled-leaf overlay against exact counts on one frame
    with shadows (not back-face culled while counting): filled-leaf counts
    equal, interior zero-sets equal, and the image is the uncounted one."""
    words, tab = _words("shell5"), _table("shell5", "combined")
    origin, dirs = _camera("deep10")
    img0, res0, none = _port_frame(words, tab, origin, dirs)
    img_c, _, counts = _port_frame(words, tab, origin, dirs, with_visits=True)
    img_f, _, flags = _port_frame(words, tab, origin, dirs, with_visits=True,
                                  visit_flags=True)
    assert none is None
    np.testing.assert_array_equal(img_c.numpy(), img0.numpy())
    np.testing.assert_array_equal(img_f.numpy(), img0.numpy())
    filled, interior = _kinds(words)
    c, f = counts.numpy(), flags.numpy()
    np.testing.assert_array_equal(c[filled], f[filled])
    np.testing.assert_array_equal(c[interior] == 0, f[interior] == 0)
    # The primary pass alone counts one per non-forced hit at its leaf.
    hits = res0.hit & ~res0.forced
    assert c[filled].sum() >= int(hits.sum()) > 0


def test_show_hits_view_is_clamped_counts():
    words = _words("shell5")
    origin, dirs = _camera("deep10")
    img, res, visits = ttracer.render_frame(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origin),
        torch.from_numpy(dirs), show_hits=True)
    g = np.minimum(visits.numpy()[np.maximum(res.index.numpy(), 0)], 15) / np.float32(15)
    g = np.where(res.hit.numpy(), g, 0).astype(np.float32) ** np.float32(2.2)
    np.testing.assert_allclose(img.numpy().reshape(-1, 3), np.stack([g] * 3, -1),
                               rtol=1e-6, atol=0)


def _jax_shadow(words, tab, hit, hit_pos, normal, cull):
    """JAX ``trace``'s hit mask and visit counts for the shadow rays of a
    primary result (NumPy arrays), built in NumPy as ``shadow_rays`` builds
    them. They start on the primary hits, inside the root cube, so their
    counts are exact under a table too (see the module docstring)."""
    neg_sun = ttracer._neg_sun(ttracer.DEFAULT_SUN)
    on = hit & ((normal[:, 0] * neg_sun[0] + normal[:, 1] * neg_sun[1])
                + normal[:, 2] * neg_sun[2] > 0) if cull else hit
    res_j, visits_j = jtracer.trace(
        jnp.asarray(words), jnp.asarray(hit_pos + normal * np.float32(2.5e-6)),
        jnp.asarray(np.broadcast_to(neg_sun, hit_pos.shape).copy()),
        active_init=jnp.asarray(on), with_visits=True,
        warp_table=None if tab is None else jnp.asarray(tab))
    return np.asarray(res_j.hit), np.asarray(visits_j)


@pytest.mark.parametrize("cull", [True, False])
def test_trace_shadow_counts_equal_shadow_rays(cull):
    """``trace_shadow`` adds its rays' counts into the array passed: JAX
    ``trace``'s counts of the same shadow rays, with the jumps' marks of
    empty leaves (the module docstring), whose closure leaves the interior
    zero-set and filled-leaf counts of the reference's trace of those rays;
    its hit mask is JAX's."""
    words, tab = _words("random6"), _table("random6", "combined")
    origin, dirs = _camera("bench")
    w, t = state.u32_to_device(words, "cpu"), state.table_to_device(tab, "cpu")
    res = ttracer.trace(w, torch.from_numpy(origin).reshape(1, 3).expand(RES * RES, 3),
                        torch.from_numpy(dirs), warp_table=t)
    base = torch.arange(words.shape[0], dtype=torch.int32) % 3
    got = base.clone()
    hit = ttracer.trace_shadow(w, res, cull=cull, warp_table=t, visits=got, image_width=RES)
    hit_j, visits_j = _jax_shadow(words, tab, res.hit.numpy(), res.hit_pos.numpy(),
                                  res.normal.numpy(), cull)
    np.testing.assert_array_equal(hit.numpy(), hit_j)
    assert_jax_marks_with_jumps(words, (got - base).numpy(), visits_j)
    o, d, on = (x.numpy() for x in ttracer.shadow_rays(res, cull=cull))
    assert_reference_zero_set(words, (got - base).numpy(), reference_visits(words, o[on], d[on]))
    assert hit.any() and visits_j.sum() > 0


@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
def test_render_frame_visits_are_primary_then_shadow_counts(flags):
    """A counted frame's visits equal JAX ``trace``'s: the primary pass's
    marks (flags then the filled-leaf overlay of tracer.py:3414-3423, or
    counts), then the counts of the shadow rays of every hit (not culled),
    added into the same array. From a camera inside the root cube, so the
    primary counts are exact under the table too; empty leaves also take
    the jumps' marks, and the closure leaves the reference frame's
    zero-set (the module docstring)."""
    words, tab = _words("random6"), _table("random6", "combined")
    origin, dirs = _camera("inside2")
    _, res, visits = _port_frame(words, tab, origin, dirs, with_visits=True,
                                 visit_flags=flags)
    flat = dirs.reshape(-1, 3)
    prim, want = jtracer.trace(
        jnp.asarray(words), jnp.asarray(np.broadcast_to(origin, flat.shape).copy()),
        jnp.asarray(flat), with_visits=True, visit_flags=flags, warp_table=jnp.asarray(tab))
    hit, index = np.asarray(prim.hit), np.asarray(prim.index)
    want = np.asarray(want).copy()
    if flags:
        leaf = hit & ~np.asarray(prim.forced) & (index >= 0)
        counts = np.zeros_like(want)
        np.add.at(counts, index[leaf], 1)
        want = np.where(counts > 0, counts, want)
    sh_hit, sh_visits = _jax_shadow(words, tab, hit, np.asarray(prim.hit_pos),
                                    np.asarray(prim.normal), cull=False)
    assert_jax_marks_with_jumps(words, visits.numpy(), want + sh_visits)
    assert_reference_zero_set(words, visits.numpy(),
                              reference_visits(words, origin, dirs, shadows=True))
    assert sh_hit.any() and sh_visits.sum() > 0
