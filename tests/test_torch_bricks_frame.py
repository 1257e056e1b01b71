"""The port's ``render_frame`` with bricks against JAX's staged frame with
the same bricks (``render_frame(mode="staged", bricks=...)``), on the CPU.

JAX's staged mode compiles its brick body into every stage of each pass,
so the frame is small (32x32 rays), has no shadow pass
(``test_torch_bricks_trace.py`` holds the shadowed frame to JAX's tiled
one) and takes one sub-step a brick trip; ``brick_k`` does not change
results (``test_torch_bricks.py`` holds 1, 4 and 7 equal). The u8 image is
held by the rule of ``test_torch_render.py``, the result fields as in
``test_torch_bricks.py``, and the visits by the two LOD invariants
(filled-leaf counts exact, interior zero-set exact).
"""

import jax.numpy as jnp
import numpy as np
import torch

from octree_tracer_tpu.render import bricks as jbricks
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu.render.camera import camera_matrices, generate_rays
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET
from octree_tracer_tpu_torch.render import bricks
from octree_tracer_tpu_torch.render import tracer as ttracer
from test_torch_bricks import CAM, _assert_exact

RES = 32


def test_brick_frame_matches_jax_staged():
    words = scenes.deep_shell(6)
    _, ci = camera_matrices(*CAM, 70.0, RES, RES)
    origin, dirs = generate_rays(ci, RES, RES)
    dec_j, br_j = jbricks.build_bricks(jnp.asarray(words))
    img_j, res_j, vis_j = jtracer.render_frame(
        dec_j, jnp.asarray(origin), jnp.asarray(dirs), jnp.asarray(jtracer.DEFAULT_SUN),
        shadows=False, mode="staged", bricks=br_j, brick_k=1, u8_image=True,
        with_visits=True)
    dec, br = bricks.build_bricks(state.u32_to_device(words, "cpu"))
    img, res, vis = ttracer.render_frame(dec, torch.from_numpy(origin),
                                         torch.from_numpy(dirs), shadows=False, bricks=br,
                                         brick_k=1, u8_image=True, with_visits=True)
    equal = np.all(img.numpy() == np.asarray(img_j), axis=-1)
    assert equal.mean() >= 0.995, f"{(~equal).sum()} pixels differ"
    _assert_exact(ttracer.to_numpy(res), ttracer.to_numpy(res_j))
    pay = words >> np.uint32(4)
    filled, interior = pay > VOXEL_OFFSET, pay < VOXEL_OFFSET
    va, vb = vis.numpy(), np.asarray(vis_j)
    np.testing.assert_array_equal(va[filled], vb[filled])
    np.testing.assert_array_equal(va[interior] == 0, vb[interior] == 0)
    assert va[filled].any() and res.hit.sum() > 50
