"""Camera: the port's host copies equal the JAX package's functions, the
plain version of raygen kernel K3 matches NumPy ``generate_rays`` within
2e-7 (the two sum the 4x4 product in different orders), and K3's matrix
arguments are packed by value as f32 row-major floats."""

import numpy as np
import pytest
import torch

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


def _inverse():
    pos, look, fov = CAMERAS["deep10"]
    return jcam.camera_matrices(pos, look, fov, 96, 40)[1]


ARG_SOURCES = {
    "numpy": lambda ci: ci,
    "numpy column-major": np.asfortranarray,
    "cpu tensor": torch.from_numpy,
    "cpu tensor transposed twice": lambda ci: torch.from_numpy(ci.T.copy()).T,
}


@pytest.mark.parametrize("source", sorted(ARG_SOURCES))
def test_raygen_args_are_f32_row_major(source):
    """K3 takes the matrix by value: 16 floats, row-major, each an f32
    value, whatever the layout of the array or CPU tensor it came in."""
    ci = _inverse()
    args = tcam._raygen_args(ARG_SOURCES[source](ci))
    assert len(args) == 16 and all(type(a) is float for a in args)
    assert all(float(np.float32(a)) == a for a in args)
    np.testing.assert_array_equal(np.array(args, np.float32), ci.reshape(16))
    assert args[4 * 2 + 3] == float(ci[2, 3])


BAD_ARGS = {
    "f64 numpy": (TypeError, lambda ci: ci.astype(np.float64)),
    "f64 tensor": (TypeError, lambda ci: torch.from_numpy(ci).double()),
    "f16 numpy": (TypeError, lambda ci: ci.astype(np.float16)),
    "3x4 numpy": (ValueError, lambda ci: ci[:3]),
    "flat tensor": (ValueError, lambda ci: torch.from_numpy(ci).reshape(16)),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_raygen_args_reject_other_matrices(case):
    exc, make = BAD_ARGS[case]
    with pytest.raises(exc):
        tcam._raygen_args(make(_inverse()))


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
    # A CPU tensor takes the same path as the NumPy matrix.
    o_c, d_c = tcam.generate_rays_device(torch.from_numpy(ci), w, h, "cpu")
    assert torch.equal(o_c, o_t) and torch.equal(d_c, d_t)
