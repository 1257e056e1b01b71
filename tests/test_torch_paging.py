"""Paged pools (``render/paging.py``) and the paged trace and frame against
the JAX package on the CPU.

``build_pages`` is equal to JAX's on every array and int. The port traces
a relayouted pool with K1 as it is (here its plain version): every field,
in relayouted slots, equals JAX's paged ``trace`` (hit_pos within the
repository's 1e-5, as ``test_torch_trace.py``), and equals the port's
unpaged trace once ``index`` is mapped back through ``old_of_new``; the
paged frame equals JAX's staged paged frame and the port's unpaged frame.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu.render import paging as jpaging
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.core import CpuOctree
from octree_tracer_tpu_torch.render import bricks, paging
from octree_tracer_tpu_torch.render import tracer as ttracer

RES = 32
CAM = (np.array([0.2, 0.3, -2.4], np.float32), np.array([-0.1, -0.15, 1.0], np.float32))
EXACT = ("hit", "forced", "index", "steps", "depth", "normal", "word")


@functools.lru_cache(maxsize=None)
def _deep_scene():
    """tests/test_paging.py:23's scene, built by the port's CpuOctree."""
    rng = np.random.default_rng(9)
    t = CpuOctree(0)
    depth, side = 7, 1 << 7
    for c in rng.integers(0, side, (3000, 3)):
        p = c.astype(np.float32) / side * 2 - 1
        t.put_in_voxel(p, int(rng.integers(1, 1 << 24)), depth)
    return t.to_words()


def _rays(res=RES):
    _, ci = camera_matrices(*CAM, 70.0, res, res)
    o, d = generate_rays(ci, res, res)
    return np.asarray(o), np.asarray(d)


CASES = [(None, 4 << 20), (1, 4 << 20), (2, 4 << 20), (3, 4 << 20), (None, 1024)]


@pytest.mark.parametrize("levels,max_bytes", CASES)
def test_build_pages_equals_jax(levels, max_bytes):
    words = _deep_scene()
    a = paging.build_pages(words, levels=levels, max_page_bytes=max_bytes)
    b = jpaging.build_pages(words, levels=levels, max_page_bytes=max_bytes)
    assert a._fields == b._fields
    for f, x, y in zip(a._fields, a, b):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert type(x) is int and x == y, f
    assert a.words.shape[0] == (a.top_rows + a.page_rows * a.n_pages) * 8
    assert set(a.old_of_new[:8]) == set(range(8))


def test_build_pages_small_pools_equal_jax():
    """A ragged pool (no multiple of 8), one of only a root group, and a
    random tree, at the default levels."""
    for words in (scenes.random_scene(4, 60, 3)[:-3], scenes.random_scene(1, 3, 0)[:8],
                  scenes.random_scene(5, 300, 7)):
        a, b = paging.build_pages(words), jpaging.build_pages(words)
        for f, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(x, y, err_msg=f)


def _remap(index, old_of_new):
    old = old_of_new[np.clip(index, 0, len(old_of_new) - 1)]
    return np.where(index >= 0, old, index)


@pytest.mark.parametrize("levels", [1, 2])
def test_paged_trace_equals_jax(levels):
    words = _deep_scene()
    o, d = _rays()
    flat = d.reshape(-1, 3)
    orig = np.broadcast_to(o.reshape(1, 3), flat.shape).copy()
    pg = paging.build_pages(words, levels=levels)
    geo = (pg.top_rows, pg.page_rows, pg.n_pages)
    a = ttracer.to_numpy(ttracer.trace(state.u32_to_device(pg.words, "cpu"),
                                       torch.from_numpy(orig), torch.from_numpy(flat),
                                       paged=geo))
    res_j, _ = jtracer.trace(jnp.asarray(pg.words), jnp.asarray(orig), jnp.asarray(flat),
                             paged=geo)
    b = ttracer.to_numpy(res_j)
    for f in EXACT:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert np.abs(a["hit_pos"] - b["hit_pos"]).max() <= 1e-5
    ref = ttracer.to_numpy(ttracer.trace(state.u32_to_device(words, "cpu"),
                                         torch.from_numpy(orig), torch.from_numpy(flat)))
    np.testing.assert_array_equal(_remap(a["index"], pg.old_of_new), ref["index"])
    for f in ref:
        if f != "index":
            np.testing.assert_array_equal(a[f], ref[f], err_msg=f)
    assert a["hit"].sum() > 50 and (a["index"] != ref["index"]).any()


def test_paged_self_cycle_trace_equals_unpaged():
    """The cyclic pool, paged: every ray's loop cap is the unpaged one, so
    the paged trace equals the unpaged trace for every ray, those that the
    cap leaves unresolved included. At ``max_steps=0`` (a cap of 52 trips)
    the rays from (2^-e, -2^-e, -2^-e) need e + 1 descents to reach the
    filled child 0, so the cap stops those with e >= 60."""
    words = scenes.malformed_pools()["self_cycle"]
    pg = paging.build_pages(words)
    geo = (pg.top_rows, pg.page_rows, pg.n_pages)
    rng = np.random.default_rng(3)
    e = np.array([40, 60, 80, 100], np.float32)
    origins = np.concatenate([rng.uniform(-0.9, 0.9, (60, 3)),
                              np.stack([2 ** -e, -2 ** -e, -2 ** -e], 1)]).astype(np.float32)
    origins[:20, 1] = 0.0  # on a centre plane: these run to the cap
    dirs = rng.normal(size=origins.shape).astype(np.float32)
    dirs[:20, 1] = 0.0
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    a = ttracer.to_numpy(ttracer.trace(state.u32_to_device(pg.words, "cpu"), o, d,
                                       max_steps=0, paged=geo))
    ref = ttracer.to_numpy(ttracer.trace(state.u32_to_device(words, "cpu"), o, d,
                                         max_steps=0))
    np.testing.assert_array_equal(_remap(a["index"], pg.old_of_new), ref["index"])
    for f in ref:
        if f != "index":
            np.testing.assert_array_equal(a[f], ref[f], err_msg=f)
    np.testing.assert_array_equal(a["hit"][-4:], [True, False, False, False])
    assert a["hit"][20:60].any()


def test_paged_frame_equals_jax_staged():
    """render_frame over the relayouted pool, hit slots mapped back, against
    JAX's staged paged frame (shadows, u8) and the port's unpaged frame."""
    words = _deep_scene()
    o, d = _rays()
    pg = paging.build_pages(words, levels=1)
    geo = (pg.top_rows, pg.page_rows, pg.n_pages)
    img_j, res_j, _ = jtracer.render_frame(
        jnp.asarray(pg.words), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(jtracer.DEFAULT_SUN), shadows=True, mode="staged", u8_image=True,
        paged=geo, paged_old_of_new=jnp.asarray(pg.old_of_new))
    img, res, visits = ttracer.render_frame(
        state.u32_to_device(pg.words, "cpu"), torch.from_numpy(o), torch.from_numpy(d),
        u8_image=True, paged=geo, paged_old_of_new=pg.old_of_new)
    assert visits is None
    equal = np.all(img.numpy() == np.asarray(img_j), axis=-1)
    assert equal.mean() >= 0.995, f"{(~equal).sum()} pixels differ"
    a, b = ttracer.to_numpy(res), ttracer.to_numpy(res_j)
    for f in EXACT:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    img_u, res_u, _ = ttracer.render_frame(state.u32_to_device(words, "cpu"),
                                           torch.from_numpy(o), torch.from_numpy(d),
                                           u8_image=True)
    assert torch.equal(img, img_u)
    for f, x, y in zip(res._fields, res, res_u):
        assert torch.equal(x, y), f
    assert res.hit.any()


def test_paged_errors():
    words = _deep_scene()
    pg = paging.build_pages(words, levels=1)
    geo = (pg.top_rows, pg.page_rows, pg.n_pages)
    w = state.u32_to_device(pg.words, "cpu")
    o, d = (torch.from_numpy(x) for x in _rays(4))
    flat = d.reshape(-1, 3)
    origins = o.reshape(1, 3).expand(flat.shape[0], 3)
    with pytest.raises(ValueError, match="paged excludes bricks/warp_table"):
        ttracer.trace(w, origins, flat, paged=geo,
                      warp_table=ttracer.build_warp_table(w, 2))
    dec, br = bricks.build_bricks(w)
    with pytest.raises(ValueError, match="paged excludes bricks/warp_table"):
        ttracer.trace(dec, origins, flat, paged=geo, bricks=br)
    with pytest.raises(ValueError, match="geometry"):
        ttracer.trace(w, origins, flat, paged=(geo[0], geo[1], geo[2] + 1))
    with pytest.raises(ValueError, match="geometry"):
        ttracer.trace_plain(w[:-8], origins, flat, paged=geo)
    with pytest.raises(ValueError, match="top_rows, page_rows, n_pages"):
        ttracer.trace(w, origins, flat, paged=geo[:2])
    for kw in (dict(with_visits=True), dict(show_hits=True)):
        with pytest.raises(ValueError, match="paged excludes with_visits/show_hits"):
            ttracer.render_frame(w, o, d, paged=geo, **kw)
