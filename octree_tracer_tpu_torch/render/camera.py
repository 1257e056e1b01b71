"""Camera model and primary-ray generation.

The host functions are the JAX package's ``render/camera.py`` NumPy code,
copied so that the port imports no module of that package (tests hold each
copy equal to its original). ``generate_rays_device`` is the counterpart of
``camera.py:80``, in pixel order or, under ``block_major``, in the block
order of ``tracer._pixel_to_block`` that JAX's beam frames take
(``render_frame(pre_permuted=True)``). On a CUDA device it launches kernel
K3 (``csrc/raygen.cu``) with the matrix by value (``_raygen_args``), on the
CPU it runs ``generate_rays_device_plain``.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from .. import kernels
from ..state import div_scalar
from ..utils import timing


def proj_matrix(fov_deg: float, aspect_h_over_w: float) -> np.ndarray:
    s = 1.0 / np.tan((fov_deg / 2.0) * (np.pi / 180.0))
    return np.diag([aspect_h_over_w * s, s, -1.0, 1.0]).astype(np.float32)


def look_at_rh(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix (row-major, applied as ``M @ v``)."""
    eye = np.asarray(eye, dtype=np.float32)
    f = np.asarray(center, dtype=np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, dtype=np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def camera_matrices(pos, look, fov_deg: float, width: int, height: int):
    """(camera, camera_inverse) for a character at ``pos`` looking along
    ``look``."""
    pos = np.asarray(pos, dtype=np.float32)
    look = np.asarray(look, dtype=np.float32)
    view = look_at_rh(pos, pos + look, np.array([0.0, 1.0, 0.0], dtype=np.float32))
    proj = proj_matrix(fov_deg, height / width)
    camera = (proj @ view).astype(np.float32)
    camera_inverse = np.linalg.inv(camera.astype(np.float64)).astype(np.float32)
    return camera, camera_inverse


def clip_space(width: int, height: int) -> np.ndarray:
    """Per-pixel clip coords of the pixel centres, y flipped."""
    xs = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
    ys = ((np.arange(height, dtype=np.float32) + 0.5) / height * 2.0 - 1.0) * -1.0
    cx, cy = np.meshgrid(xs, ys)  # (H, W)
    return np.stack([cx, cy], axis=-1)


def generate_rays(camera_inverse: np.ndarray, width: int, height: int):
    """(origin f32[3], dirs f32[H, W, 3]) on the host, by inverse projection
    of clip-space points at z=1."""
    ci = camera_inverse.astype(np.float32)
    origin_h = ci @ np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)
    origin = origin_h[:3] / origin_h[3]

    cs = clip_space(width, height)  # (H, W, 2)
    pts = np.concatenate(
        [cs, np.ones(cs.shape[:-1] + (2,), dtype=np.float32)], axis=-1
    )  # (H, W, 4) = (cx, cy, 1, 1)
    world = pts @ ci.T  # (H, W, 4)
    world = world[..., :3] / world[..., 3:4]
    dirs = world - origin
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origin.astype(np.float32), dirs.astype(np.float32)


def default_character():
    """Spawn state: position and look direction."""
    pos = np.array([0.1, 0.2, -1.5], dtype=np.float32)
    look = -np.array([0.0, 0.0, -1.5], dtype=np.float32)
    return pos, look


def _check_block(width: int, height: int, block_major: int) -> int:
    block = operator.index(block_major)
    if block < 0 or (block and (width % block or height % block)):
        raise ValueError(f"block_major {block_major} must be 0 or divide {width}x{height}")
    if block and 3 * width * height >= 1 << 31:
        raise ValueError(f"{width}x{height} rays: K3's block order indexes floats in int32")
    return block


def generate_rays_device_plain(camera_inverse: torch.Tensor, width: int,
                               height: int, block_major: int = 0):
    """Plain PyTorch version of kernel K3, term by term as the kernel
    computes it. Returns (origin f32[3], dirs f32[H, W, 3]), or under
    ``block_major`` > 0 dirs f32[H*W, 3] in its block order, each ray's
    pixel taken from its place as JAX's ``_device_raygen`` takes it
    (camera.py:117-126): the same values, reordered."""
    block = _check_block(width, height, block_major)
    ci = camera_inverse
    origin = ci[:3, 3] / ci[3, 3]  # ci @ (0, 0, 0, 1), over its w
    dev = ci.device
    if block:
        i = torch.arange(width * height, dtype=torch.int64, device=dev)
        tile, lane = i // (block * block), i % (block * block)
        py = (tile // (width // block)) * block + lane // block
        px = (tile % (width // block)) * block + lane % block
        cx = div_scalar(px.to(torch.float32) + 0.5, width) * 2.0 - 1.0
        cy = -(div_scalar(py.to(torch.float32) + 0.5, height) * 2.0 - 1.0)
    else:
        xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
        xs = div_scalar(xs, width) * 2.0 - 1.0
        ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)
        ys = -(div_scalar(ys, height) * 2.0 - 1.0)
        cx = xs[None, :].expand(height, width)
        cy = ys[:, None].expand(height, width)
    world = [((cx * ci[j, 0] + cy * ci[j, 1]) + ci[j, 2]) + ci[j, 3]
             for j in range(4)]
    d = [world[j] / world[3] - origin[j] for j in range(3)]
    norm = torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    return origin, torch.stack([c / norm for c in d], dim=-1)


def _raygen_args(camera_inverse) -> tuple[float, ...]:
    """The 16 entries of a f32[4, 4] inverse camera matrix (NumPy array or
    tensor), row-major, as the Python floats of their f32 values: K3's
    arguments by value. A CUDA tensor is read back to the host first, which
    waits for the stream."""
    if isinstance(camera_inverse, torch.Tensor):
        camera_inverse = camera_inverse.detach().cpu().numpy()
    a = np.asarray(camera_inverse)
    if a.dtype != np.float32:
        raise TypeError(f"camera_inverse must be float32, got {a.dtype}")
    if a.shape != (4, 4):
        raise ValueError(f"camera_inverse must have shape (4, 4), got {a.shape}")
    return tuple(float(v) for v in a.reshape(16))


def generate_rays_device(camera_inverse, width: int, height: int, device="cuda",
                         block_major: int = 0):
    """(origin f32[3], dirs f32[H, W, 3]) on ``device`` (the card unless
    the caller passes the CPU) from the 4x4 inverse camera matrix (f32
    NumPy array or tensor).

    ``block_major`` > 0 (it must divide both sides) returns dirs f32[H*W,
    3] in the block order of ``tracer._pixel_to_block`` with that block,
    as JAX's ``generate_rays_device(block_major=)`` does: the input
    ``render_frame(mode="beam", beams=block_major, pre_permuted=True)``
    takes, reshaped to [H, W, 3].

    On a CUDA device the matrix goes to kernel K3 by value: a NumPy array or
    a CPU tensor costs no copy to the card and no wait. A CUDA tensor is
    accepted too, at the price of one device-to-host read, which waits for
    the stream; the port's callers pass NumPy."""
    with timing.span("render.raygen"):
        device = kernels.resolve_device(device)
        block = _check_block(width, height, block_major)
        if not kernels.uses_kernel(device):
            ci = torch.as_tensor(camera_inverse).to(device)
            kernels.check(ci, "camera_inverse", torch.float32, (4, 4))
            return generate_rays_device_plain(ci, width, height, block)
        args = _raygen_args(camera_inverse)
        origin = torch.empty(3, dtype=torch.float32, device=device)
        shape = (height * width, 3) if block else (height, width, 3)
        dirs = torch.empty(shape, dtype=torch.float32, device=device)
        kernels.launch("raygen", "ot_raygen", device, *args, width, height, block,
                       kernels.ptr(origin), kernels.ptr(dirs))
        return origin, dirs
