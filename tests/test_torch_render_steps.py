"""Frame views: ``show_steps`` and ``misc_bool`` (``>=`` descent, gamma
1.0) of the port's ``render_frame`` against the JAX package.

``show_steps`` with ``misc_bool`` is held against JAX ``render_frame(mode=
"beam")``; the shaded ``misc_bool`` frame against JAX's composition of the
same frame (``trace`` with ``strict_descent=False``, the shadow ``trace`` and
``shade`` with gamma 1.0). Images agree within 1e-6 on the agreeing rays.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.render import tracer as ttracer

RES = 64
LEVELS = 3


@functools.lru_cache(maxsize=None)
def _inputs():
    words = scenes.random_scene(5, 400, 4)
    table = np.asarray(jskip.build_warp_skip_table(jnp.asarray(words), LEVELS))
    _, ci = camera_matrices(np.array([0.4, 0.6, -2.2], np.float32),
                            np.array([-0.2, -0.35, 1.0], np.float32), 70.0, RES, RES)
    origin, dirs = generate_rays(ci, RES, RES)
    return words, table, origin, dirs


def _port(**kw):
    words, table, origin, dirs = _inputs()
    return ttracer.render_frame(
        state.u32_to_device(words, "cpu"), torch.from_numpy(origin),
        torch.from_numpy(dirs), warp_table=state.table_to_device(table, "cpu"), **kw)


def test_show_steps_misc_bool_matches_jax():
    words, table, origin, dirs = _inputs()
    img_j, res_j, _ = jtracer.render_frame(
        jnp.asarray(words), jnp.asarray(origin), jnp.asarray(dirs),
        jnp.asarray(jtracer.DEFAULT_SUN), show_steps=True, misc_bool=True,
        mode="beam", warp_table=jnp.asarray(table))
    img, res, _ = _port(show_steps=True, misc_bool=True)
    agree = ttracer.agreement(ttracer.to_numpy(res), ttracer.to_numpy(res_j))
    assert (~agree).mean() < 0.005
    diff = np.abs(img.numpy() - np.asarray(img_j)).reshape(-1, 3)
    assert diff[agree].max() <= 1e-6
    assert len(np.unique(img.numpy())) > 5


def test_misc_bool_shaded_frame_matches_jax_composition():
    words, table, origin, dirs = _inputs()
    n = RES * RES
    wj, tj = jnp.asarray(words), jnp.asarray(table)
    oj = jnp.broadcast_to(jnp.asarray(origin).reshape(1, 3), (n, 3))
    res_j, _ = jtracer.trace(wj, oj, jnp.asarray(dirs.reshape(-1, 3)),
                             strict_descent=False, warp_table=tj)
    sun = jnp.asarray(jtracer.DEFAULT_SUN, jnp.float32)
    sun = sun / jnp.linalg.norm(sun)
    sh_j, _ = jtracer.trace(
        wj, res_j.hit_pos + res_j.normal * 2.5e-6, jnp.broadcast_to(-sun, (n, 3)),
        active_init=res_j.hit & ((res_j.normal * -sun).sum(-1) > 0),
        strict_descent=False, warp_table=tj)
    img_j = np.asarray(jtracer.shade(wj, res_j, sh_j.hit, gamma=1.0))

    img, res, _ = _port(misc_bool=True)
    agree = ttracer.agreement(ttracer.to_numpy(res), ttracer.to_numpy(res_j))
    assert (~agree).mean() < 0.005
    diff = np.abs(img.numpy().reshape(n, 3) - img_j)
    assert diff[agree].max() <= 1e-6
    u8, _, _ = _port(misc_bool=True, u8_image=True)
    u8_j = np.asarray(jtracer.encode_u8(jnp.asarray(img_j)))
    assert np.all(u8.numpy().reshape(n, 3) == u8_j, axis=-1).mean() >= 0.995
