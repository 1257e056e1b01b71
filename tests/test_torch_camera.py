"""Camera: the port's host copies equal the JAX package's functions, and the
plain version of raygen kernel K3 matches NumPy ``generate_rays`` within
2e-7 (the two sum the 4x4 product in different orders)."""

import numpy as np
import pytest

from octree_tracer_tpu.render import camera as jcam
from octree_tracer_tpu_torch.render import camera as tcam

CAMERAS = {
    "default": (*jcam.default_character(), 90.0),
    "bench": (np.array([0.4, 0.6, -2.2], np.float32),
              np.array([-0.2, -0.35, 1.0], np.float32), 70.0),
    "deep10": (np.array([0.2, 0.3, -2.4], np.float32),
               np.array([-0.1, -0.15, 1.0], np.float32), 70.0),
}


@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("size", [(64, 64), (96, 40)])
def test_host_copies_equal_jax_package(cam, size):
    pos, look, fov = CAMERAS[cam]
    w, h = size
    for a, b in zip(tcam.camera_matrices(pos, look, fov, w, h),
                    jcam.camera_matrices(pos, look, fov, w, h)):
        np.testing.assert_array_equal(a, b)
    ci = jcam.camera_matrices(pos, look, fov, w, h)[1]
    for a, b in zip(tcam.generate_rays(ci, w, h), jcam.generate_rays(ci, w, h)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcam.default_character(), jcam.default_character()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("size", [(64, 64), (96, 40)])
def test_raygen_plain_matches_numpy(cam, size):
    pos, look, fov = CAMERAS[cam]
    w, h = size
    _, ci = jcam.camera_matrices(pos, look, fov, w, h)
    o_np, d_np = jcam.generate_rays(ci, w, h)
    o_t, d_t = tcam.generate_rays_device(ci, w, h, "cpu")
    assert tuple(d_t.shape) == (h, w, 3)
    assert np.abs(o_t.numpy() - o_np).max() <= 2e-7
    assert np.abs(d_t.numpy() - d_np).max() <= 2e-7
