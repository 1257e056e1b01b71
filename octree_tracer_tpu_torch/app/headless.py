"""Headless rendering: scene -> image -> PNG (the JAX package's
``app/headless.py``).

``render_scene`` renders on the card by default: the rays from kernel K3
(``camera.generate_rays_device``), then the port's ``render_frame``, whose
primary and shadow passes run K1 and whose shading and u8 encode run K4; on
the CPU (``device="cpu"``) the plain PyTorch versions. ``backend="oracle"``
keeps the NumPy oracle. ``tile_size``, ``mode`` and ``beams`` go to
``render_frame`` (JAX's ``render_scene`` takes ``tile_size`` and picks the
tiled mode for ``show_hits`` and the staged one otherwise, whose outputs
are the port's default frame's).

PNG files are written with ``zlib`` and ``struct`` from the standard
library (one IHDR chunk, filter-0 rows, IEND): no image library is needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .. import kernels
from ..io import load_file
from ..render import camera as cam
from ..state import u32_to_device


def parse_camera(spec: str | None):
    """'px,py,pz:lx,ly,lz' -> (pos, look); None -> the spawn camera."""
    if not spec:
        return cam.default_character()
    p, l = spec.split(":")
    pos = np.array([float(x) for x in p.split(",")], dtype=np.float32)
    look = np.array([float(x) for x in l.split(",")], dtype=np.float32)
    return pos, look


def render_scene(
    scene_path: str,
    width: int = 512,
    height: int = 512,
    fov: float = 90.0,
    camera: str | None = None,
    sun_dir=(-1.7, -1.0, 0.8),
    shadows: bool = True,
    show_steps: bool = False,
    show_hits: bool = False,
    misc_bool: bool = False,
    octree_depth: int = 12,
    backend: str = "device",
    device="cuda",
    tile_size: int | None = 128 * 1024,
    mode: str | None = None,
    beams: int | None = None,
):
    """Load a scene file and render one frame.

    ``backend="device"`` renders on ``device`` (the card unless the caller
    asks for the CPU) and returns (u8[H, W, 3] NumPy image, as K4 encodes
    it, TraceResult on ``device``); ``"oracle"`` runs the NumPy oracle and
    returns (f32[H, W, 3] image, result dict), as the JAX ``render_scene``
    does."""
    tree = load_file(scene_path, octree_depth)
    words = tree.to_words()
    pos, look = parse_camera(camera)
    _, cam_inv = cam.camera_matrices(pos, look, fov, width, height)

    if backend == "oracle":
        from ..render import cpu_reference

        origin, dirs = cam.generate_rays(cam_inv, width, height)
        img, result, _ = cpu_reference.render_frame(
            words, origin, dirs, sun_dir=sun_dir, shadows=shadows,
            show_steps=show_steps, strict_descent=not misc_bool,
            gamma=2.2 - 1.2 * misc_bool,
        )
        return np.asarray(img), result
    if backend != "device":
        raise ValueError(f"unknown backend {backend!r} (device or oracle)")

    from ..render import tracer

    dev = kernels.resolve_device(device)
    origin, dirs = cam.generate_rays_device(cam_inv, width, height, dev)
    img, result, _ = tracer.render_frame(
        u32_to_device(words, dev), origin, dirs, sun_dir=sun_dir, shadows=shadows,
        show_steps=show_steps, show_hits=show_hits, misc_bool=misc_bool, u8_image=True,
        tile_size=tile_size, mode=mode, beams=beams,
    )
    return img.cpu().numpy(), result


def encode_u8(img: np.ndarray) -> np.ndarray:
    """The display encode of an image: u8 input as it is; f32[H, W, 3]
    linear input as ``clip^(1/2.2) * 255`` truncated, the JAX
    ``save_png``'s host encode."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    srgb = np.clip(img, 0.0, 1.0) ** (1.0 / 2.2)
    return (srgb * 255.0).astype(np.uint8)


def png_bytes(img: np.ndarray) -> bytes:
    """An image (see ``encode_u8``) as the bytes of an 8-bit RGB PNG."""
    u8 = np.ascontiguousarray(encode_u8(img))
    if u8.ndim != 3 or u8.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got shape {u8.shape}")
    h, w = u8.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, 3 * w)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, filter 0
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def save_png(img: np.ndarray, path: str) -> None:
    """Write an image as PNG: f32[H, W, 3] linear input is display-encoded,
    u8[H, W, 3] input (a u8 frame, e.g. ``Session.render``'s) is written
    verbatim."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def fetch_frame(img: torch.Tensor):
    """Start copying a frame to the host and return a function that waits
    for the copy and returns the NumPy image. On the card the copy is a
    non-blocking one into pinned memory behind an event, so a caller that
    waits one tick later overlaps it with the next frame's work."""
    if not img.is_cuda:
        host = img.numpy()
        return lambda: host
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    host.copy_(img, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(img.device))

    def wait() -> np.ndarray:
        ready.synchronize()
        return host.numpy()

    return wait
