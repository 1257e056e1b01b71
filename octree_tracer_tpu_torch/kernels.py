"""The port's CUDA kernel library: build, load, launch, count.

The kernels in ``csrc/*.cu`` compile with ``nvcc`` into one shared library
with a plain C interface, loaded with ctypes. It is built from the sources at
first use, into ``_build/`` beside this file, under a name keyed on a hash of
the sources and flags, so an edit rebuilds it: one ``nvcc -c`` per source, all
started together, then one link. Importing this module builds nothing and
needs neither a GPU nor ``nvcc``.

Each wrapper in the port validates its tensors, allocates its outputs with
``torch.empty`` and calls :func:`launch`, which runs the C entry point on the
current CUDA stream, raises if the launch reported an error, and adds one to
the kernel's count in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# --fmad=false keeps FMA contraction from moving knife-edge rays; no
# --use_fast_math, so IEEE division, sqrtf and powf stay (csrc/common.cuh).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches of each kernel since the last reset_launches().
LAUNCHES = {"trace": 0, "warp_occupancy": 0, "raygen": 0, "shade_encode": 0,
            "select_candidates": 0, "propagate_visits": 0, "block_grid": 0,
            "gather_rows": 0, "add_scalar": 0, "brick_rows": 0, "beam_start": 0,
            "skip_field": 0}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_U32 = ctypes.c_uint32
# argtypes of each C entry point; the last argument is always the stream.
_SIGNATURES = {
    "ot_trace": [_P, _I64, _P, _I, _P, _P, _I64, _I, _P, _I, _I, _I, _I, _I, _I]
                + [_P] * 9 + [_I, _P, _I, _P, _P, _P, _I, _P],
    "ot_trace_shadow": [_P, _I64, _P, _P, _P, _F, _F, _F, _I, _I64, _I, _P, _I, _I, _I,
                        _I, _I, _I] + [_P] * 3 + [_I, _I, _P],
    "ot_warp_occupancy": [_P, _I64, _I, _P, _P, _P],
    "ot_raygen": [_F] * 16 + [_I, _I, _I, _P, _P, _P],
    "ot_shade_encode": [_P] * 6 + [_I64, _F, _F, _F, _I, _F] + [_P, _P, _I64, _P, _P]
                       + [_I, _I, _I, _I, _P],
    "ot_encode_table": [_P, _F, _P],
    "ot_encode_check": [_P, _P, _P],
    "ot_select_candidates": [_P, _P, _I64, _I64, _I64, _I, _I, _P, _I64, _P, _I],
    "ot_propagate_visits": [_P, _I64, _P, _P, _P],
    "ot_brick_rows": [_P, _I64, _I, _P, _P, _P],
    "ot_skip_field": [_P, _I, _I, _P, _P, _I64, _P],
    "ot_beam_start": [_P, _I64, _P, _P, _I, _I, _I, _I, _I] + [_P] * 6,
    "ot_block_grid": [_F, _F, _F, _F, _I, _P, _P],
    "ot_gather_rows": [_P, _P, _I64, _P, _I, _I, _I64, _I64, _I, _I64, _I, _P],
    "ot_add_scalar_f32": [_P, _P, _I64, _I64, _I64, _I64, _I, _F, _P, _P],
    "ot_add_scalar_u32": [_P, _P, _I64, _I64, _I64, _I64, _I, _U32, _P, _P],
}

_lib = None


def sources() -> list[str]:
    """Paths of the CUDA sources, in a fixed order."""
    return [
        os.path.join(CSRC_DIR, f) for f in sorted(os.listdir(CSRC_DIR))
        if f.endswith((".cu", ".cuh"))
    ]


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libot_kernels_{h.hexdigest()[:16]}.so")


def nvcc_path() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def build() -> tuple[str, str]:
    """Compile the library unless this source hash is already built.

    Returns (library path, compiler output); the output holds ptxas's
    register and spill report of every kernel."""
    path = library_path()
    log_path = path + ".log"
    if os.path.exists(path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return path, log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = nvcc_path()
    units = [p for p in sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in units]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", "-o", o, p],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for p, o in zip(units, objs)]
    try:
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        for proc, unit, out in zip(procs, units, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(unit)} with "
                                   f"code {proc.returncode}:\n{out}")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed with code {link.returncode}:\n"
                           f"{link.stderr}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return path, log


def register_report(log: str) -> list[tuple[str, int, int, int]]:
    """(entry function, registers, spill store bytes, spill load bytes) of
    each kernel in ptxas's ``-v`` report (the log :func:`build` returns)."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name is not None:
            out.append((name, int(m.group(1)), *spills))
            name = None
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(kernel: str, entry: str, device: torch.device, *args,
           counted: bool = True) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream; raise if
    the launch failed, else count one launch of ``kernel`` (unless
    ``counted`` is false: a helper of the kernel, such as K4's table)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(library(), entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    if counted:
        LAUNCHES[kernel] += 1


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer for a ctypes ``c_void_p`` argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a host
    without one, so an entry point that defaults to the card never drops to
    the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available; "
                           "pass device='cpu' for the plain PyTorch versions")
    return device


def uses_kernel(device: torch.device) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU (run
    the plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def check(t, name: str, dtype: torch.dtype, shape: tuple | None = None,
          device: torch.device | None = None, broadcast_rows: bool = False) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (and ``shape``,
    where None entries match any size, and ``device``). ``broadcast_rows``
    also takes a 2-D tensor whose rows are all one contiguous row (stride
    ``(0, 1)``, as ``expand`` makes)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and (
        t.dim() != len(shape)
        or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if broadcast_rows and t.dim() == 2 and t.stride() == (0, 1):
        return
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
