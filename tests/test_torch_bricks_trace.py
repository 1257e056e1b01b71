"""K1's brick DDA (``trace_plain(bricks=...)``, the plain version of K1's
brick mode) against the JAX package on the CPU, beyond the cases of
``test_torch_bricks.py``: random trees and rays (origins outside the cube
included), forced caps, an explicit trip cap, the malformed pools, decorated
pools without bricks, the shadow mode, the oracle, the tiled frame, and the
generated island terrain from its grazing camera (``scenes.terrain``, the
scene bricks are for). Fields are held as in ``test_torch_bricks.py``
(hit_pos within 1e-5).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu.render import bricks as jbricks
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET
from octree_tracer_tpu_torch.render import bricks, cpu_reference
from octree_tracer_tpu_torch.render import tracer as ttracer
from test_torch_bricks import (CAM, INSIDE, RES, _assert_exact, _assert_same, _fuzz_rays,
                               _jax, _pool, _port, _rays, _tree)


@pytest.mark.parametrize("seed,depth,voxels", [(23, 2, 12), (24, 3, 80), (25, 5, 400),
                                               (26, 6, 900)])
def test_fuzz_trees_equal_jax(seed, depth, voxels):
    """Random trees, random rays from inside and outside the cube (out of
    bounds origins included): JAX's fields and counts."""
    words = _tree(depth, voxels, seed)
    o, d = _fuzz_rays(seed)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, o, d, visits=visits)
    b, vb = _jax(words, o, d, with_visits=True)
    _assert_exact(a, b)
    np.testing.assert_array_equal(visits.numpy(), vb)


def test_forced_cap_and_out_of_bounds():
    """A dense slab at max_steps=6: forced hits and rays leaving the cube
    round through the brick DDA as in JAX and as without bricks."""
    words = _tree(4, 500, 3, side_depth=4)
    o, d = _fuzz_rays(3, span=1.0)
    a = _port(words, o, d, max_steps=6)
    b, _ = _jax(words, o, d, max_steps=6)
    _assert_exact(a, b)
    plain = ttracer.to_numpy(ttracer.trace(state.u32_to_device(words, "cpu"),
                                           torch.from_numpy(o), torch.from_numpy(d),
                                           max_steps=6))
    _assert_same(a, plain)
    assert a["forced"].any() and (~a["hit"]).any()


@pytest.mark.parametrize("k", [1, 4])
def test_max_iters_leaves_jax_rays_unresolved(k):
    """A ray's trips depend on brick_k; under an explicit cap the rays left
    unresolved are JAX's."""
    words = _pool("random6")
    o, d = _rays(INSIDE)
    a = _port(words, o, d, brick_k=k, max_iters=12)
    b, _ = _jax(words, o, d, brick_k=k, max_iters=12)
    _assert_exact(a, b)
    full = _port(words, o, d, brick_k=k)
    assert a["hit"].sum() < full["hit"].sum()


@pytest.mark.parametrize("pool", ["past_end16", "ragged21", "moved_random"])
def test_malformed_pool_brick_trace_equals_jax(pool):
    """Pointers past the pool's end: JAX's brick mode reads one table of
    pool rows and then brick rows, so a row past the pool is a brick row;
    every field and count equal to JAX's."""
    words = scenes.malformed_pools()[pool]
    o, d = _rays(INSIDE, 24)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, o, d, visits=visits)
    b, vb = _jax(words, o, d, with_visits=True)
    _assert_exact(a, b)
    np.testing.assert_array_equal(visits.numpy(), vb)
    assert a["hit"].any()


def test_self_cycle_brick_trace_equals_plain():
    """The cyclic pool has no brick root; with its (zero) table the brick
    form equals the traversal without bricks, loop cap included."""
    words = scenes.malformed_pools()["self_cycle"]
    o, d = _rays((np.array([0.0, 0.3, -0.45], np.float32),
                  np.array([0.3, -0.5, 1.0], np.float32)), 24)
    a = _port(words, o, d, max_iters=600)
    b = ttracer.to_numpy(ttracer.trace(state.u32_to_device(words, "cpu"),
                                       torch.from_numpy(o), torch.from_numpy(d),
                                       max_iters=600))
    _assert_same(a, b)


@pytest.mark.parametrize("table", ["none", "warp", "combined"])
def test_decorated_pool_without_bricks_is_undecorated(table):
    """Bit 0 lies in the nibble ``>> 4`` drops: every other form of K1's
    plain version on the decorated pool gives the undecorated pool's
    results and visits."""
    from octree_tracer_tpu_torch.render import skip

    words = _pool("random6")
    w = state.u32_to_device(words, "cpu")
    dec, _ = bricks.build_bricks(w)
    t = None
    if table == "warp":
        t = ttracer.build_warp_table(w, 3)
    elif table == "combined":
        t = skip.build_warp_skip_table(w, 3)
    o, d = (torch.from_numpy(x) for x in _rays(INSIDE))
    for restart in (True, False):
        va, vb = (torch.zeros(words.shape[0], dtype=torch.int32) for _ in range(2))
        a = ttracer.trace(dec, o, d, warp_table=t, visits=va, parent_restart=restart)
        b = ttracer.trace(w, o, d, warp_table=t, visits=vb, parent_restart=restart)
        _assert_same(ttracer.to_numpy(a), ttracer.to_numpy(b))
        assert torch.equal(va, vb)
        hb = ttracer.trace_shadow(dec, a, warp_table=t, image_width=RES)
        assert torch.equal(hb, ttracer.trace_shadow(w, b, warp_table=t, image_width=RES))


def test_brick_shadow_pass_equals_plain_rays():
    """K1's shadow mode with bricks (on the CPU shadow_rays + trace_plain)
    equals JAX ``trace(bricks=...)`` on the shadow rays built in NumPy."""
    words = _pool("random6")
    dec, br = bricks.build_bricks(state.u32_to_device(words, "cpu"))
    o, d = _rays(INSIDE)
    res = ttracer.trace(dec, torch.from_numpy(o), torch.from_numpy(d), bricks=br)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    hit = ttracer.trace_shadow(dec, res, cull=False, visits=visits, bricks=br, brick_k=3,
                               image_width=RES)
    neg_sun = ttracer._neg_sun(ttracer.DEFAULT_SUN)
    o_np = res.hit_pos.numpy() + res.normal.numpy() * np.float32(2.5e-6)
    d_np = np.broadcast_to(neg_sun, o_np.shape).copy()
    jdec, jbr = jbricks.build_bricks(jnp.asarray(words))
    jres, expect = jtracer.trace(jdec, jnp.asarray(o_np), jnp.asarray(d_np),
                                 active_init=jnp.asarray(res.hit.numpy()), bricks=jbr,
                                 brick_k=3, with_visits=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jres.hit))
    np.testing.assert_array_equal(visits.numpy(), np.asarray(expect))
    assert hit.any() and (res.hit & ~hit).any()


def test_brick_trace_agrees_with_oracle():
    """The brick trace against the NumPy oracle within the knife-edge
    budget (0.5% of rays)."""
    words = _pool("random6")
    o, d = _rays()
    a = _port(words, o, d)
    res_o = cpu_reference.trace_rays(words, o[0], d)
    agree = ttracer.agreement(a, res_o)
    assert (~agree).mean() < 0.005 and a["hit"].sum() > 100


TERRAIN_DEPTH, TERRAIN_W, TERRAIN_H = 5, 48, 27


@functools.lru_cache(maxsize=None)
def _terrain():
    """The island terrain at chunk_depth 5 (its grid by the plain version)
    and the grazing camera's rays at 48x27."""
    words = scenes.terrain(TERRAIN_DEPTH, device="cpu")
    pos, look, fov = scenes.TERRAIN_CAMERA
    _, ci = camera_matrices(pos, look, fov, TERRAIN_W, TERRAIN_H)
    o, d = generate_rays(ci, TERRAIN_W, TERRAIN_H)
    d = np.asarray(d).reshape(-1, 3)
    return words, np.broadcast_to(np.asarray(o), d.shape).copy(), d


@pytest.mark.parametrize("restart", [True, False])
@pytest.mark.parametrize("k", [1, 4])
def test_terrain_brick_trace_equals_jax(restart, k):
    """The terrain from its grazing camera (inside the root cube): every
    field and every visit slot equal to JAX ``trace(bricks=...)``, in both
    restart forms, and every field equal to the port's traversal without
    bricks. The rays cross fine cells inside bricks."""
    words, o, d = _terrain()
    kw = dict(parent_restart=restart, brick_k=k)
    visits = torch.zeros(words.shape[0], dtype=torch.int32)
    a = _port(words, o, d, visits=visits, **kw)
    b, vb = _jax(words, o, d, with_visits=True, **kw)
    _assert_exact(a, b)
    np.testing.assert_array_equal(visits.numpy(), vb)
    plain = ttracer.to_numpy(ttracer.trace(state.u32_to_device(words, "cpu"),
                                           torch.from_numpy(o), torch.from_numpy(d),
                                           parent_restart=restart))
    _assert_same(a, plain)
    assert a["hit"].mean() > 0.4 and (~a["hit"]).any()


def test_terrain_scene_and_camera():
    """The terrain is the island (stone and grass leaves, no block
    reference left), and the camera sits inside the root cube above its
    top: the rays that hit, hit at grazing depths below the camera."""
    words, o, d = _terrain()
    payload = words >> np.uint32(4)
    leaves = payload[payload >= VOXEL_OFFSET] - VOXEL_OFFSET
    assert set(np.unique(leaves)) == {0, 0x808080, 0x40A030}
    pos = scenes.TERRAIN_CAMERA[0]
    assert np.all(np.abs(pos) < 1.0)
    res = ttracer.to_numpy(ttracer.trace(state.u32_to_device(words, "cpu"),
                                         torch.from_numpy(o), torch.from_numpy(d)))
    assert (res["hit_pos"][res["hit"], 1] < pos[1]).all()
    np.testing.assert_array_equal(words, scenes.terrain(TERRAIN_DEPTH, device="cpu"))


def _filled_interior(words):
    pay = words >> np.uint32(4)
    return pay > VOXEL_OFFSET, pay < VOXEL_OFFSET


def test_brick_frame_matches_jax_tiled():
    """render_frame with bricks (shadows, u8, counted) against JAX's tiled
    frame (``trace`` with bricks for both passes): the u8 image by
    test_torch_render.py's rule, every result field, and the visits by the
    two LOD invariants (filled-leaf counts exact, interior zero-set
    exact)."""
    words = scenes.deep_shell(6)
    _, ci = camera_matrices(*CAM, 70.0, RES, RES)
    origin, dirs = generate_rays(ci, RES, RES)
    dec_j, br_j = jbricks.build_bricks(jnp.asarray(words))
    img_j, res_j, vis_j = jtracer.render_frame(
        dec_j, jnp.asarray(origin), jnp.asarray(dirs), jnp.asarray(jtracer.DEFAULT_SUN),
        shadows=True, bricks=br_j, brick_k=3, u8_image=True, with_visits=True)
    dec, br = bricks.build_bricks(state.u32_to_device(words, "cpu"))
    img, res, vis = ttracer.render_frame(dec, torch.from_numpy(origin),
                                         torch.from_numpy(dirs), bricks=br, brick_k=3,
                                         u8_image=True, with_visits=True)
    equal = np.all(img.numpy() == np.asarray(img_j), axis=-1)
    assert equal.mean() >= 0.995, f"{(~equal).sum()} pixels differ"
    _assert_exact(ttracer.to_numpy(res), ttracer.to_numpy(res_j))
    filled, interior = _filled_interior(words)
    va, vb = vis.numpy(), np.asarray(vis_j)
    np.testing.assert_array_equal(va[filled], vb[filled])
    np.testing.assert_array_equal(va[interior] == 0, vb[interior] == 0)
    assert va[filled].any()
