"""Traversal: the port's ``trace`` (on the CPU, the plain version of kernel
K1) against JAX ``tracer.trace`` and the NumPy oracle.

The budget is the repository's (tests/test_tracer.py:1-11): hit, index,
steps, depth, normal and word agree on at least 99.5% of rays, and hit_pos
is within 1e-5 on the agreeing rays. Under a combined warp+skip table the
port computes the skip planes with JAX's association (clo + cw - B*cw,
tracer.py:554-561; ADVICE r5 notes it can differ from the plain march's by
an ulp), and ``steps`` counts one per skip as JAX does, not one per cell as
the oracle does.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jump_marks import assert_jax_marks_with_jumps, skip_free

from octree_tracer_tpu.core import CpuOctree
from octree_tracer_tpu.render import cpu_reference as joracle
from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, default_character, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.render import cpu_reference as toracle
from octree_tracer_tpu_torch.render import tracer as ttracer

RES = 64
LEVELS = 4
SCENES = {
    "shell5": lambda: scenes.deep_shell(5),
    "random5": lambda: scenes.random_scene(5, 300, 1),
    "random6": lambda: scenes.random_scene(6, 2000, 2),
}
CAMERAS = {
    "bench": (np.array([0.4, 0.6, -2.2], np.float32),
              np.array([-0.2, -0.35, 1.0], np.float32), 70.0),
    "deep10": (np.array([0.2, 0.3, -2.4], np.float32),
               np.array([-0.1, -0.15, 1.0], np.float32), 70.0),
    "default": (*default_character(), 90.0),
}


@functools.lru_cache(maxsize=None)
def _words(scene):
    return SCENES[scene]()


@functools.lru_cache(maxsize=None)
def _table(scene, kind):
    words = jnp.asarray(_words(scene))
    if kind == "warp":
        return np.asarray(jtracer.build_warp_table(words, LEVELS))
    return np.asarray(jskip.build_warp_skip_table(words, LEVELS))


def _rays(cam):
    pos, look, fov = CAMERAS[cam]
    _, ci = camera_matrices(pos, look, fov, RES, RES)
    o, d = generate_rays(ci, RES, RES)
    flat = d.reshape(-1, 3)
    return np.broadcast_to(o, flat.shape).copy(), flat


def _jax(words, origins, dirs, table=None, **kw):
    res, _ = jtracer.trace(
        jnp.asarray(words), jnp.asarray(origins), jnp.asarray(dirs),
        warp_table=None if table is None else jnp.asarray(table), **kw)
    return ttracer.to_numpy(res)


def _port(words, origins, dirs, table=None, active=None, **kw):
    res = ttracer.trace(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origins),
        torch.from_numpy(dirs),
        active_init=None if active is None else torch.from_numpy(active),
        warp_table=None if table is None else state.table_to_device(table, "cpu"),
        **kw)
    return ttracer.to_numpy(res)


def _assert_agree(a, b, budget=0.005):
    agree = ttracer.agreement(a, b)
    assert (~agree).mean() < budget, f"{(~agree).sum()} of {agree.size} disagree"
    if agree.any():
        assert np.abs(a["hit_pos"] - b["hit_pos"])[agree].max() <= 1e-5
    return agree


@pytest.mark.parametrize("scene", ["shell5", "random6"])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("table", ["none", "warp", "combined"])
def test_trace_matches_jax(table, strict, scene):
    origins, dirs = _rays("bench")
    tab = None if table == "none" else _table(scene, table)
    words = _words(scene)
    a = _port(words, origins, dirs, tab, strict_descent=strict)
    b = _jax(words, origins, dirs, tab, strict_descent=strict)
    _assert_agree(a, b)
    assert a["hit"].sum() > 0 and (~a["hit"]).sum() > 0


@pytest.mark.parametrize("table", ["none", "combined"])
def test_active_init_matches_jax(table):
    origins, dirs = _rays("deep10")
    active = np.random.default_rng(5).random(dirs.shape[0]) < 0.6
    tab = None if table == "none" else _table("random5", table)
    words = _words("random5")
    a = _port(words, origins, dirs, tab, active=active)
    b = _jax(words, origins, dirs, tab, active_init=jnp.asarray(active))
    _assert_agree(a, b)
    off = ~active
    assert not a["hit"][off].any() and (a["index"][off] == -1).all()
    assert (a["steps"][off] == 0).all() and (a["hit_pos"][off] == 0).all()


@pytest.mark.parametrize("cam,scene", [("bench", "shell5"), ("deep10", "random5"),
                                       ("default", "random5"), ("bench", "random6")])
def test_no_table_matches_oracle(cam, scene):
    origins, dirs = _rays(cam)
    words = _words(scene)
    a = _port(words, origins, dirs)
    b = joracle.trace_rays(words, origins[0], dirs)
    _assert_agree(a, b)


@pytest.mark.parametrize("table", ["none", "combined"])
def test_step_cap_matches_jax(table):
    """A low step cap forces hits (red in the frame): forced rays report the
    stepped position and normal, steps = cap + 1 and depth = cap."""
    origins, dirs = _rays("bench")
    words = _words("random6")
    tab = None if table == "none" else _table("random6", table)
    a = _port(words, origins, dirs, tab, max_steps=3)
    b = _jax(words, origins, dirs, tab, max_steps=3)
    _assert_agree(a, b)
    np.testing.assert_array_equal(a["forced"], b["forced"])
    assert a["forced"].any()
    assert (a["steps"][a["forced"]] == 4).all() and (a["depth"][a["forced"]] == 3).all()
    assert (a["index"][a["forced"]] == -1).all() and (a["word"][a["forced"]] == 0).all()


@pytest.mark.parametrize("table", ["none", "warp", "combined"])
def test_word_invariant(table):
    """word is words[index] on real hits, 0 on misses and forced hits."""
    origins, dirs = _rays("bench")
    words = _words("random6")
    tab = None if table == "none" else _table("random6", table)
    a = _port(words, origins, dirs, tab)
    real = a["hit"] & ~a["forced"]
    assert real.any()
    np.testing.assert_array_equal(a["word"][real], words[a["index"][real]])
    assert (a["word"][~real] == 0).all()


def test_skip_counts_one_step_per_skip():
    """Under the combined table hits are those of the plain march, and steps
    never exceed its cell-by-cell count."""
    origins, dirs = _rays("deep10")
    words = _words("shell5")
    plain = _port(words, origins, dirs)
    skip = _port(words, origins, dirs, _table("shell5", "combined"))
    np.testing.assert_array_equal(plain["hit"], skip["hit"])
    np.testing.assert_array_equal(plain["index"], skip["index"])
    assert (skip["steps"] <= plain["steps"]).all()
    assert skip["steps"].sum() < plain["steps"].sum()


@pytest.mark.parametrize("depth,voxels", [(2, 12), (4, 60), (5, 200)])
def test_random_trees_match_jax_and_oracle(depth, voxels):
    """Random trees built through CpuOctree.put_in_voxel and random rays,
    inside and outside the root cube (as tests/test_tracer.py:300-311)."""
    rng = np.random.default_rng(7 + depth)
    tree = CpuOctree(0)
    side = 1 << depth
    for c in rng.integers(0, side, (voxels, 3)):
        tree.put_in_voxel(c.astype(np.float32) / side * 2 - 1,
                          int(rng.integers(1, 1 << 24)), depth)
    words = tree.to_words()
    origins = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    a = _port(words, origins, dirs)
    _assert_agree(a, _jax(words, origins, dirs))
    _assert_agree(a, joracle.trace_rays(words, origins, dirs))


@pytest.mark.parametrize("strict", [True, False])
def test_oracle_copy_equals_jax_oracle(strict):
    origins, dirs = _rays("deep10")
    words = _words("random6")
    visits_t = np.zeros(words.shape[0], np.int64)
    visits_j = np.zeros(words.shape[0], np.int64)
    a = toracle.trace_rays(words, origins, dirs, visits=visits_t, strict_descent=strict)
    b = joracle.trace_rays(words, origins, dirs, visits=visits_j, strict_descent=strict)
    for f in b:
        np.testing.assert_array_equal(a[f], b[f])
    np.testing.assert_array_equal(visits_t, visits_j)


def _trace_t(words, origins, dirs, table=None, **kw):
    return ttracer.trace(
        state.u32_to_device(words, "cpu"), origins, dirs,
        warp_table=None if table is None else state.table_to_device(table, "cpu"), **kw)


@pytest.mark.parametrize("table", ["none", "combined"])
def test_expanded_origins_and_image_dirs_equal_flat_call(table):
    """One origin as a stride-0 ``expand`` view, and dirs as an image
    [H, W, 3], give the contiguous flat call's results exactly."""
    origins, dirs = _rays("bench")
    words = _words("random6")
    tab = None if table == "none" else _table("random6", table)
    flat = _trace_t(words, torch.from_numpy(origins), torch.from_numpy(dirs), tab)
    one = torch.from_numpy(origins[:1]).expand(dirs.shape[0], 3)
    assert one.stride() == (0, 1)
    image = torch.from_numpy(dirs).reshape(RES, RES, 3)
    for res in (_trace_t(words, one, torch.from_numpy(dirs), tab),
                _trace_t(words, one, image, tab)):
        for f, a, b in zip(ttracer.TraceResult._fields, res, flat):
            assert torch.equal(a, b), f
    assert flat.hit.any()


def _shadow_inputs(table):
    origins, dirs = _rays("deep10")
    words = _words("shell5")
    tab = None if table == "none" else _table("shell5", table)
    res = _trace_t(words, torch.from_numpy(origins), torch.from_numpy(dirs), tab)
    return words, tab, res


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("table", ["none", "combined"])
def test_trace_shadow_equals_shadow_rays_and_plain_trace(table, cull):
    """``trace_shadow``'s rays are ``shadow_rays``'s, which equal the rays
    built from the result in NumPy, and its hit mask is JAX ``trace``'s on
    those rays, on every ray."""
    words, tab, res = _shadow_inputs(table)
    w = state.u32_to_device(words, "cpu")
    t = None if tab is None else state.table_to_device(tab, "cpu")
    hit = ttracer.trace_shadow(w, res, cull=cull, warp_table=t, image_width=RES)
    assert hit.dtype == torch.bool and hit.shape == res.hit.shape

    neg_sun = ttracer._neg_sun(ttracer.DEFAULT_SUN)
    normal, pos, prim = res.normal.numpy(), res.hit_pos.numpy(), res.hit.numpy()
    on = prim & ((normal[:, 0] * neg_sun[0] + normal[:, 1] * neg_sun[1])
                 + normal[:, 2] * neg_sun[2] > 0) if cull else prim
    o_np = pos + normal * np.float32(2.5e-6)
    d_np = np.broadcast_to(neg_sun, pos.shape).copy()
    o, d, active = ttracer.shadow_rays(res, cull=cull)
    for a, b in ((o, o_np), (d, d_np), (active, on)):
        np.testing.assert_array_equal(a.numpy(), b)
    b = _jax(words, o_np, d_np, tab, active_init=jnp.asarray(on))
    np.testing.assert_array_equal(hit.numpy(), b["hit"])
    assert hit.any() and (res.hit & ~hit).any()


def _sh(w, r, image_width=RES, **kw):
    return ttracer.trace_shadow(w, r, image_width=image_width, **kw)


SHADOW_CASES = {
    "u8 hit": (TypeError, lambda w, r: _sh(w, r._replace(hit=r.hit.to(torch.uint8)))),
    "f64 hit_pos": (TypeError, lambda w, r: _sh(w, r._replace(hit_pos=r.hit_pos.double()))),
    "short normal": (ValueError, lambda w, r: _sh(w, r._replace(normal=r.normal[:-1]))),
    "strided normal": (ValueError, lambda w, r: _sh(
        w, r._replace(normal=torch.cat([r.normal, r.normal], 1)[:, ::2]))),
    "two-component sun": (ValueError, lambda w, r: _sh(w, r, sun_dir=(1.0, 0.0))),
    "zero sun": (ValueError, lambda w, r: _sh(w, r, sun_dir=(0.0, 0.0, 0.0))),
    "nan sun": (ValueError, lambda w, r: _sh(w, r, sun_dir=(np.nan, 1.0, 0.0))),
    "width not dividing": (ValueError, lambda w, r: _sh(w, r, image_width=RES + 1)),
    "width not given": (TypeError, lambda w, r: ttracer.trace_shadow(w, r)),
    "i64 visits": (TypeError, lambda w, r: _sh(
        w, r, visits=torch.zeros(w.shape[0], dtype=torch.int64))),
    "origins stride (0, 2)": (ValueError, lambda w, r: ttracer.trace(
        w, torch.zeros(1, 6).expand(r.hit.shape[0], 6)[:, ::2], r.normal)),
    "strided image dirs": (ValueError, lambda w, r: ttracer.trace(
        w, r.hit_pos, torch.cat([r.normal, r.normal], 1)[:, ::2].reshape(RES, RES, 3))),
}


@pytest.mark.parametrize("case", sorted(SHADOW_CASES))
def test_shadow_and_trace_reject_malformed_inputs(case):
    words, _, res = _shadow_inputs("none")
    exc, call = SHADOW_CASES[case]
    with pytest.raises(exc):
        call(state.u32_to_device(words, "cpu"), res)


# The pools whose pointers run past their end; self_cycle is held to the
# oracle below (JAX's CPU 1 / exp2(d) is inexact from depth 13 on).
MALFORMED = {k: v for k, v in scenes.malformed_pools().items() if k != "self_cycle"}
MAL_RES = 24  # 576 rays
MAL_LEVELS = 3
INSIDE = (np.array([-0.35, 0.55, -0.6], np.float32), np.array([0.3, -0.5, 1.0], np.float32))
EXACT = ("hit", "forced", "index", "steps", "depth", "normal", "word")


def _mal_rays(inside=False):
    pos, look = INSIDE if inside else CAMERAS["bench"][:2]
    _, ci = camera_matrices(pos, look, 70.0, MAL_RES, MAL_RES)
    o, d = generate_rays(ci, MAL_RES, MAL_RES)
    d = np.asarray(d).reshape(-1, 3)
    return np.broadcast_to(np.asarray(o), d.shape).copy(), d


@functools.lru_cache(maxsize=None)
def _mal_table(pool, kind):
    if kind == "none":
        return None
    words = jnp.asarray(MALFORMED[pool])
    if kind == "warp":
        return np.asarray(jtracer.build_warp_table(words, MAL_LEVELS))
    return np.asarray(jskip.build_warp_skip_table(words, MAL_LEVELS))


def _assert_exact(a, b):
    for f in EXACT:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    # hit_pos: JAX's CPU build contracts the position update differently
    # (an ulp); the repository's rule holds it within 1e-5.
    assert np.abs(a["hit_pos"] - b["hit_pos"]).max() <= 1e-5


@pytest.mark.parametrize("table", ["none", "warp", "combined"])
@pytest.mark.parametrize("pool", sorted(MALFORMED))
def test_malformed_pool_trace_equals_jax(pool, table):
    """Pointers past the pool's end: the port reads the clamped row JAX's
    gather reads, and reports the unclamped slot as JAX does, so hit,
    index, steps, depth, normal and word are equal on every ray."""
    origins, dirs = _mal_rays()
    words, tab = MALFORMED[pool], _mal_table(pool, table)
    a = _port(words, origins, dirs, tab)
    b = _jax(words, origins, dirs, tab)
    _assert_exact(a, b)
    assert a["hit"].any() and (a["index"] >= words.shape[0]).any()


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("table", ["none", "combined"])
@pytest.mark.parametrize("pool", sorted(MALFORMED))
def test_malformed_pool_visits_equal_jax(pool, table, flags):
    """Visit marks land on JAX's slots: node + child, dropped past the
    pool's end, counted or flagged. From a camera inside the root cube (a
    table's resume from outside differs by JAX's CPU face rounding, see
    test_torch_visits.py). Under the combined table the jumps also mark
    empty leaves, which JAX's leave unread, and count a root descent's
    steps, JAX's without the jumps (``jump_marks``)."""
    origins, dirs = _mal_rays(inside=True)
    words, tab = MALFORMED[pool], _mal_table(pool, table)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, origins, dirs, tab, visits=visits, visit_flags=flags)
    res, expect = jtracer.trace(
        jnp.asarray(words), jnp.asarray(origins), jnp.asarray(dirs),
        warp_table=None if tab is None else jnp.asarray(tab), with_visits=True,
        visit_flags=flags)
    b = ttracer.to_numpy(res)
    if tab is not None:
        b["steps"] = _jax(words, origins, dirs, skip_free(tab))["steps"]
    _assert_exact(a, b)
    if tab is None:
        np.testing.assert_array_equal(visits.numpy(), np.asarray(expect))
    else:
        assert_jax_marks_with_jumps(words, visits.numpy(), np.asarray(expect))
    # past_end16's table resumes every ray at group 16, whose marks all drop.
    assert a["hit"].any() and (visits.numpy().any() or pool == "past_end16")


@pytest.mark.parametrize("pool", sorted(MALFORMED))
def test_malformed_pool_shadow_equals_jax(pool):
    """K1's shadow mode on a malformed pool: its hit mask and its counts
    are JAX ``trace``'s on the shadow rays built in NumPy, with the jumps'
    marks of empty leaves (``jump_marks``)."""
    origins, dirs = _mal_rays(inside=True)
    words, tab = MALFORMED[pool], _mal_table(pool, "combined")
    w, t = state.u32_to_device(words, "cpu"), state.table_to_device(tab, "cpu")
    res = ttracer.trace(w, torch.from_numpy(origins), torch.from_numpy(dirs), warp_table=t)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    hit = ttracer.trace_shadow(w, res, cull=False, warp_table=t, visits=visits,
                               image_width=MAL_RES)
    neg_sun = ttracer._neg_sun(ttracer.DEFAULT_SUN)
    o_np = res.hit_pos.numpy() + res.normal.numpy() * np.float32(2.5e-6)
    d_np = np.broadcast_to(neg_sun, o_np.shape).copy()
    jres, expect = jtracer.trace(jnp.asarray(words), jnp.asarray(o_np), jnp.asarray(d_np),
                                 active_init=jnp.asarray(res.hit.numpy()),
                                 warp_table=jnp.asarray(tab), with_visits=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jres.hit))
    assert_jax_marks_with_jumps(words, visits.numpy(), np.asarray(expect))
    assert hit.any() and (res.hit & ~hit).any()


def test_overlay_drops_hits_past_the_pool():
    """A hit whose slot lies past the pool's end adds no filled-leaf count,
    as JAX's dropping scatter (tracer.py:3419-3422)."""
    words = MALFORMED["past_end16"]
    origins, dirs = _mal_rays(inside=True)
    w = state.u32_to_device(words, "cpu")
    flags = torch.zeros(words.shape[0], dtype=torch.int32)
    res = ttracer.trace(w, torch.from_numpy(origins), torch.from_numpy(dirs), visits=flags,
                        visit_flags=True)
    assert res.hit.any() and bool((res.index[res.hit] >= words.shape[0]).all())
    assert torch.equal(ttracer.overlay_hit_counts(flags, res), flags)


def test_malformed_pool_show_hits_equals_jax():
    """The hit-counter view reads each hit's visit count at its slot,
    clamped into the pool as JAX's gather clamps it: a hit past the pool's
    end shows the pool's last count, as in JAX ``shade``."""
    words = MALFORMED["ragged21"]
    origins, dirs = _mal_rays(inside=True)
    res, visits = jtracer.trace(jnp.asarray(words), jnp.asarray(origins), jnp.asarray(dirs),
                                with_visits=True)
    port = ttracer.TraceResult(*(torch.from_numpy(np.asarray(f).copy()) for f in res))
    port = port._replace(word=port.word.view(torch.int32))
    assert bool((port.index >= words.shape[0]).any())
    expect = np.asarray(jtracer.shade(jnp.asarray(words), res, None, show_hits_visits=visits))
    got = ttracer.shade(port, None, hits_visits=torch.from_numpy(np.asarray(visits).copy()))
    np.testing.assert_allclose(got.numpy(), expect, rtol=0, atol=1e-6)


def test_pow2_exact_down_to_subnormals():
    """``_pow2(e)`` is 2^e bit for bit for every e in [-149, 127], the
    subnormals below -126 included, and 0 below -149."""
    e = np.arange(-160, 128)
    got = ttracer._pow2(torch.from_numpy(e)).numpy()
    expect = np.ldexp(np.float32(1.0), e).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))
    assert (got[e < -149] == 0).all() and (got[e >= -149] > 0).all()


@pytest.mark.parametrize("start", [0, 1, 7, 31])
def test_halved_half_side_equals_pow2(start):
    """K1 sets its half side 2^-(depth + 1) from the exponent bits where a
    descent starts (``start`` levels down, at most 31) and halves it in f32
    at each level below: that gives ``_pow2`` bit for bit at every level to
    200, 2^-149 included and 0 past it."""
    depth = np.arange(start, 201)
    half = np.empty(depth.size, np.float32)
    h = np.ldexp(np.float32(1.0), -(start + 1)).astype(np.float32)
    for i in range(depth.size):
        half[i] = h
        h = np.float32(h * np.float32(0.5))
    expect = ttracer._pow2(torch.from_numpy(-(depth + 1))).numpy()
    np.testing.assert_array_equal(half.view(np.uint32), expect.view(np.uint32))


def _cycle_rays(n=512, seed=0):
    """Random rays, half from outside the root cube; on about half of them
    one axis of the origin and of the direction is 0, so the entry point
    lies exactly on that axis's centre plane and the descent's centre
    approaches it from below one exact power of two at a time."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    origins[: n // 2] *= np.float32(2.5)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    on_plane = rng.random(n) < 0.5
    origins[on_plane, axis[on_plane]] = 0.0
    dirs[on_plane, axis[on_plane]] = 0.0
    return origins, dirs


@functools.lru_cache(maxsize=None)
def _cycle_results():
    words = scenes.malformed_pools()["self_cycle"]
    origins, dirs = _cycle_rays()
    with np.errstate(over="ignore"):  # the oracle's exp2(d) overflows from d = 128
        oracle = toracle.trace_rays(words, origins, dirs)
    return words, origins, dirs, _port(words, origins, dirs), oracle


def test_self_cycle_pool_equals_oracle():
    """A pool whose pointers cycle: rays on a centre plane descend past 126
    levels, where the powers of two turn subnormal and then 0, and run to
    the loop's cap without a hit, as the oracle's do; every other ray ends
    at child 0. Every output equal to the oracle's on every ray."""
    words, origins, dirs, a, b = _cycle_results()
    for f in ("hit", "forced", "index", "steps", "depth", "normal", "hit_pos"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    inside = np.all(np.abs(origins) < 1.0, axis=1)
    enters = inside | (toracle._ray_box_dist(origins, dirs) > 0)
    unended = enters & ~b["hit"]
    assert a["hit"].sum() > 100 and unended.sum() > 100


def test_self_cycle_pool_jax_differs_only_past_depth_12():
    """JAX's CPU build computes 1 / exp2(d), which is a few ulps off 2^-d at
    every d in 13-149 but 14, so its deep descents on the cyclic pool may
    end elsewhere. The rays where it differs from the port are counted, and
    each is one the oracle traced past 12 levels or to the cap."""
    words, origins, dirs, a, b = _cycle_results()
    j = _jax(words, origins, dirs)
    differ = ~ttracer.agreement(a, j)
    deep = (b["depth"] > 12) | ~b["hit"]
    assert not (differ & ~deep).any()
    print(f"JAX differs from the port on {int(differ.sum())} of {differ.size} rays")
