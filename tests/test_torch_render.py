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
