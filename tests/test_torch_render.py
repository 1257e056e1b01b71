"""Frame: the port's ``render_frame`` (on the CPU, the plain versions of
kernels K1 and K4) against JAX ``render_frame(mode="beam")`` with shadows,
the combined warp+skip table and the u8 encode, on the same host rays.

The u8 frame is equal on at least 99.5% of pixels. The f32 image, which the
JAX frame does not return beside the u8 one, is held against JAX's own
composition of the same frame (``trace``, the back-face-culled shadow
``trace`` and ``shade``, which the beam frame equals by contract) within 1e-6
on the rays whose primary and shadow results agree.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.render import tracer as ttracer

RES = 64
LEVELS = 4


@functools.lru_cache(maxsize=None)
def _frame_inputs():
    words = scenes.deep_shell(6)
    table = np.asarray(jskip.build_warp_skip_table(jnp.asarray(words), LEVELS))
    _, ci = camera_matrices(np.array([0.2, 0.3, -2.4], np.float32),
                            np.array([-0.1, -0.15, 1.0], np.float32), 70.0, RES, RES)
    origin, dirs = generate_rays(ci, RES, RES)
    return words, table, origin, dirs


@pytest.fixture(scope="module")
def jax_frame():
    words, table, origin, dirs = _frame_inputs()
    img, res, _ = jtracer.render_frame(
        jnp.asarray(words), jnp.asarray(origin), jnp.asarray(dirs),
        jnp.asarray(jtracer.DEFAULT_SUN), shadows=True, mode="beam",
        warp_table=jnp.asarray(table), u8_image=True)
    return np.asarray(img), ttracer.to_numpy(res)


def _port_frame(u8_image):
    words, table, origin, dirs = _frame_inputs()
    img, res, visits = ttracer.render_frame(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origin),
        torch.from_numpy(dirs), shadows=True,
        warp_table=state.table_to_device(table, "cpu"), u8_image=u8_image)
    assert visits is None
    return img, res


def test_u8_frame_matches_jax(jax_frame):
    img_j, _ = jax_frame
    img, _ = _port_frame(u8_image=True)
    assert img.dtype == torch.uint8 and tuple(img.shape) == (RES, RES, 3)
    equal = np.all(img.numpy() == img_j, axis=-1)
    assert equal.mean() >= 0.995, f"{(~equal).sum()} pixels differ"
    assert len(np.unique(img_j.reshape(-1, 3), axis=0)) > 10


def test_frame_result_matches_jax(jax_frame):
    """The fields the frame consumes. JAX's shadowed beam frame reports
    ``steps`` and ``depth`` that differ from its own ``trace`` on this frame
    (on about a third of the rays, nearly all misses), so those two fields
    are held against ``trace`` in test_torch_trace.py."""
    _, res_j = jax_frame
    _, res = _port_frame(u8_image=True)
    a = ttracer.to_numpy(res)
    agree = np.all(a["normal"] == res_j["normal"], axis=-1)
    for f in ("hit", "forced", "index", "word"):
        agree &= a[f] == res_j[f]
    assert (~agree).mean() < 0.005
    assert np.abs(a["hit_pos"] - res_j["hit_pos"])[agree].max() <= 1e-5
    assert a["hit"].sum() > 0


def test_f32_frame_matches_jax_composition():
    words, table, origin, dirs = _frame_inputs()
    n = RES * RES
    wj, tj = jnp.asarray(words), jnp.asarray(table)
    oj = jnp.broadcast_to(jnp.asarray(origin).reshape(1, 3), (n, 3))
    res_j, _ = jtracer.trace(wj, oj, jnp.asarray(dirs.reshape(-1, 3)), warp_table=tj)
    sun = jnp.asarray(jtracer.DEFAULT_SUN, jnp.float32)
    sun = sun / jnp.linalg.norm(sun)
    sh_j, _ = jtracer.trace(
        wj, res_j.hit_pos + res_j.normal * 2.5e-6, jnp.broadcast_to(-sun, (n, 3)),
        active_init=res_j.hit & ((res_j.normal * -sun).sum(-1) > 0), warp_table=tj)
    img_j = np.asarray(jtracer.shade(wj, res_j, sh_j.hit, gamma=2.2))

    img, res = _port_frame(u8_image=False)
    sh_o, sh_d, sh_a = ttracer.shadow_rays(res)
    sh = ttracer.trace(state.u32_to_device(words, "cpu"), sh_o, sh_d, active_init=sh_a,
                       warp_table=state.table_to_device(table, "cpu"))
    agree = ttracer.agreement(ttracer.to_numpy(res), ttracer.to_numpy(res_j))
    agree &= sh.hit.numpy() == np.asarray(sh_j.hit)
    assert (~agree).mean() < 0.005
    assert sh.hit.numpy().any()
    diff = np.abs(img.numpy().reshape(n, 3) - img_j)
    assert diff[agree].max() <= 1e-6


@pytest.mark.parametrize("misc_bool", [False, True])
def test_render_frame_shadow_pass_is_trace_shadow(misc_bool):
    """The frame's shadow pass is ``trace_shadow`` over its primary result
    (back faces culled), which is ``shadow_rays`` + ``trace``'s hit mask: the
    f32 image equals ``shade`` of that composition exactly."""
    words, table, origin, dirs = _frame_inputs()
    w, t = state.u32_to_device(words, "cpu"), state.table_to_device(table, "cpu")
    img, res, _ = ttracer.render_frame(w, torch.from_numpy(origin), torch.from_numpy(dirs),
                                       warp_table=t, misc_bool=misc_bool)
    sh = ttracer.trace_shadow(w, res, warp_table=t, strict_descent=not misc_bool,
                              image_width=RES)
    o, d, active = ttracer.shadow_rays(res)
    want = ttracer.trace(w, o, d, active_init=active, warp_table=t,
                         strict_descent=not misc_bool).hit
    assert torch.equal(sh, want) and sh.any()
    gamma = 1.0 if misc_bool else 2.2
    np.testing.assert_array_equal(img.numpy().reshape(-1, 3),
                                  ttracer.shade(res, sh, gamma=gamma).numpy())


def test_k4_bytes_counts_lit_sectors():
    """K4's bound: 2 bytes of masks (hit, forced) and the output a ray, plus
    each 32-byte sector of shadow_hit (32 rays a sector), word (8 rays a
    sector) and normal (12 bytes a ray, so a ray's entry may straddle two
    sectors) that holds a lit pixel's entry, once; no shadow_hit sectors
    for a frame without shadows."""
    n = 64
    none = torch.zeros(n, dtype=torch.bool)
    assert ttracer.k4_bytes(none) == n * 5
    assert ttracer.k4_bytes(none, 12) == n * 14
    assert ttracer.k4_bytes(none, shadow=False) == n * 5
    every = torch.ones(n, dtype=torch.bool)
    assert ttracer.k4_bytes(every) == n * 5 + n + 4 * n + 12 * n  # whole arrays
    assert ttracer.k4_bytes(every, shadow=False) == n * 5 + 4 * n + 12 * n
    one = none.clone()
    one[0] = True  # shadow and word sector 0; normal bytes 0-11 in sector 0
    assert ttracer.k4_bytes(one) == n * 5 + 32 + 32 + 32
    assert ttracer.k4_bytes(one, shadow=False) == n * 5 + 32 + 32
    two = none.clone()
    two[2] = True  # normal bytes 24-35: sectors 0 and 1
    assert ttracer.k4_bytes(two) == n * 5 + 32 + 32 + 64
    pair = none.clone()
    pair[[2, 3]] = True  # same shadow and word sector; normal bytes 24-47: 0, 1
    assert ttracer.k4_bytes(pair) == n * 5 + 32 + 32 + 64
    apart = none.clone()
    apart[[0, 8, 63]] = True  # shadow sectors 0, 1; word 0, 1, 7; normal 0, 3, 23
    assert ttracer.k4_bytes(apart) == n * 5 + 2 * 32 + 3 * 32 + 3 * 32
    wide = torch.zeros(256, dtype=torch.bool)
    wide[[5, 40, 200]] = True  # shadow sectors 0, 1, 6
    assert ttracer.k4_bytes(wide) - ttracer.k4_bytes(wide, shadow=False) == 3 * 32
    image = every.reshape(8, 8)
    assert ttracer.k4_bytes(image) == ttracer.k4_bytes(every)


@functools.lru_cache(maxsize=None)
def _table():
    return ttracer.encode_table_plain()


def _encode_samples():
    """f32 values in [0, 1] where the table encode can fail: every
    threshold and bucket start with their neighbours two bit patterns
    either side, the ends, and 2^20 random bit patterns."""
    t = _table()
    edges = torch.cat([t[1:256].view(torch.int32).long(),
                       (torch.arange(ttracer.ENCODE_TABLE_SIZE - 262) + (109 << 6)) << 17])
    near = (edges[:, None] + torch.arange(-2, 3)[None, :]).flatten()
    rng = np.random.default_rng(7)
    bits = np.concatenate([near.numpy(), [0, 1, 0x3F800000, 0x3F7FFFFF],
                           rng.integers(0, 0x3F800001, 1 << 20)])
    bits = np.clip(bits, 0, 0x3F800000).astype(np.int32)
    return torch.from_numpy(bits).view(torch.float32)


def test_encode_table_layout():
    """Entry k < 256 is the least value the encode maps to k or more (the
    value one bit pattern below maps below k), sorted and under 1; then the
    shared values and bytes for the gamma; then each bucket's encode at its
    start, non-decreasing, the last one 1.0's."""
    t = _table()
    assert t.dtype == torch.float32 and t.shape == (ttracer.ENCODE_TABLE_SIZE,)
    assert ttracer.ENCODE_TABLE_SIZE == 262 + 1153
    th = t[:256]
    assert float(th[0]) == 0.0 and bool((th[1:] > th[:-1]).all()) and float(th[255]) < 1.0
    k = torch.arange(1, 256)
    below = (th.view(torch.int32)[1:] - 1).view(torch.float32)
    assert bool((ttracer.encode_u8_plain(th[1:]).long() >= k).all())
    assert bool((ttracer.encode_u8_plain(below).long() < k).all())
    assert float(th[1]) >= 2.0 ** -18  # below the first bucket everything encodes to 0
    shared = ttracer._pow(torch.tensor([0.2, 1.0, 0.0]), 2.2)  # the plain path's pow
    assert torch.equal(t[256:259], shared)
    assert torch.equal(t[259:262], ttracer.encode_u8_plain(shared).float())
    buckets = t[262:]
    assert bool((buckets[1:] >= buckets[:-1]).all()) and float(buckets[-1]) == 255.0
    linear = ttracer.encode_table_plain(1.0)
    assert torch.equal(linear[:256], th) and torch.equal(linear[262:], buckets)
    assert linear[256:262].tolist() == [np.float32(0.2), 1.0, 0.0, 122.0, 255.0, 0.0]


def test_encode_search_equals_the_encode():
    """K4's table encode gives the port's ``encode_u8_plain`` byte on every
    sampled f32 in [0, 1] (thresholds, bucket starts and their neighbours,
    random values), and JAX ``encode_u8``'s by the u8 rule (at least 99.9%
    equal, never more than 1 apart: XLA's CPU ``pow`` rounds a few
    knife-edge values the other way); values past [0, 1] clip."""
    c = _encode_samples()
    got = ttracer.encode_search_plain(c, _table()).numpy()
    np.testing.assert_array_equal(got, ttracer.encode_u8_plain(c).numpy())
    want = np.asarray(jtracer.encode_u8(jnp.asarray(c.numpy())))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    out = torch.tensor([-1.0, -0.0, 2.0, float("inf"), float("nan")])
    assert ttracer.encode_search_plain(out, _table()).tolist() == [0, 0, 255, 255, 0]


def test_encode_search_keeps_image_shape():
    img = torch.rand(5, 7, 3, generator=torch.Generator().manual_seed(3))
    got = ttracer.encode_search_plain(img, _table())
    assert got.dtype == torch.uint8 and got.shape == (5, 7, 3)
    assert torch.equal(got, ttracer.encode_u8_plain(img))
