"""The PyTorch port imports with JAX blocked, builds nothing at import, and
its kernel wrappers reject tensors the kernels do not take."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from octree_tracer_tpu_torch import kernels, scenes, state
from octree_tracer_tpu_torch.adaptive import feedback
from octree_tracer_tpu_torch.render import camera, tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import octree_tracer_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "octree_tracer_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        loaded = [m for m, mod in sys.modules.items() if mod is not None]
        assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
        assert not [m for m in loaded if m.split(".")[0] == "octree_tracer_tpu"]
        from octree_tracer_tpu_torch import kernels, native
        assert kernels._lib is None and native._lib is None
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 43
    for mod in ("io", "io.vox", "io.rsvo", "io.rsvo_export", "io.vox_export",
                "gen.structures", "utils", "utils.timing", "app.headless", "app.cli",
                "app.viewer", "parallel", "parallel.mesh", "parallel.session",
                "parallel.launch", "parallel.dryrun"):
        assert f"octree_tracer_tpu_torch.{mod}" in names


@pytest.fixture(scope="module")
def small():
    words = state.u32_to_device(scenes.random_scene(3, 20, 0), "cpu")
    rng = np.random.default_rng(0)
    dirs = torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32))
    origins = torch.full((16, 3), -2.0)
    res = tracer.trace(words, origins, dirs)
    return words, origins, dirs, res


CASES = {
    "trace f64 dirs": (TypeError, lambda w, o, d, r: tracer.trace(w, o, d.double())),
    "trace i64 words": (TypeError, lambda w, o, d, r: tracer.trace(w.long(), o, d)),
    "trace u8 active": (TypeError, lambda w, o, d, r: tracer.trace(
        w, o, d, active_init=torch.ones(16, dtype=torch.uint8))),
    "trace f32 table": (TypeError, lambda w, o, d, r: tracer.trace(
        w, o, d, warp_table=torch.zeros(8))),
    "trace short origins": (ValueError, lambda w, o, d, r: tracer.trace(w, o[:8], d)),
    "trace strided dirs": (ValueError, lambda w, o, d, r: tracer.trace(
        w, o, torch.cat([d, d], 1)[:, ::2])),
    "trace meta device": (ValueError, lambda w, o, d, r: tracer.trace(
        w.to("meta"), o.to("meta"), d.to("meta"))),
    "warp_occupancy i64 words": (TypeError, lambda w, o, d, r: tracer.warp_occupancy(
        w.long(), 2)),
    "raygen f64 matrix": (TypeError, lambda w, o, d, r: camera.generate_rays_device(
        np.eye(4), 8, 8, "cpu")),
    "shade f64 normal": (TypeError, lambda w, o, d, r: tracer.shade(
        r._replace(normal=r.normal.double()))),
    "shade u8 shadow": (TypeError, lambda w, o, d, r: tracer.shade(
        r, shadow_hit=r.hit.to(torch.uint8))),
    "table bad length": (ValueError, lambda w, o, d, r: state.table_to_device(
        np.zeros(10, np.uint32), "cpu")),
    "trace i64 visits": (TypeError, lambda w, o, d, r: tracer.trace(
        w, o, d, visits=torch.zeros(w.shape[0], dtype=torch.int64))),
    "trace short visits": (ValueError, lambda w, o, d, r: tracer.trace(
        w, o, d, visits=torch.zeros(w.shape[0] - 8, dtype=torch.int32))),
    "trace strided visits": (ValueError, lambda w, o, d, r: tracer.trace(
        w, o, d, visits=torch.zeros(2 * w.shape[0], dtype=torch.int32)[::2])),
    "shade f32 hits_visits": (TypeError, lambda w, o, d, r: tracer.shade(
        r, hits_visits=torch.zeros(w.shape[0]))),
    "shade strided hits_visits": (ValueError, lambda w, o, d, r: tracer.shade(
        r, hits_visits=torch.zeros(2 * w.shape[0], dtype=torch.int32)[::2])),
    "select i64 visits": (TypeError, lambda w, o, d, r: feedback.select_candidates_packed(
        w, torch.zeros(w.shape[0], dtype=torch.int64), w.shape[0])),
    "select short visits": (ValueError, lambda w, o, d, r: feedback.select_candidates_packed(
        w, torch.zeros(8, dtype=torch.int32), w.shape[0])),
    "select strided words": (ValueError, lambda w, o, d, r: feedback.select_candidates_packed(
        torch.cat([w, w])[::2], torch.zeros(w.shape[0], dtype=torch.int32), w.shape[0])),
    "select negative cap": (ValueError, lambda w, o, d, r: feedback.select_candidates_packed(
        w, torch.zeros(w.shape[0], dtype=torch.int32), w.shape[0], sub_cap=-1)),
    "propagate f32 visits": (TypeError, lambda w, o, d, r: feedback.propagate_visits(
        w, torch.zeros(w.shape[0]), 2)),
    "propagate short visits": (ValueError, lambda w, o, d, r: feedback.propagate_visits(
        w, torch.zeros(w.shape[0] + 8, dtype=torch.int32), 2)),
    "propagate strided visits": (ValueError, lambda w, o, d, r: feedback.propagate_visits(
        w, torch.zeros(2 * w.shape[0], dtype=torch.int32)[::2], 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_rejects_bad_tensors(small, case):
    exc, call = CASES[case]
    with pytest.raises(exc):
        call(*small)


def test_library_path_keyed_on_sources_and_flags(monkeypatch):
    path = kernels.library_path()
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert kernels.library_path() == path
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert kernels.library_path() != path
    assert "--fmad=false" in kernels.NVCC_FLAGS
    assert not any("fast_math" in f for f in kernels.NVCC_FLAGS)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "octree_tracer_tpu_torch/_build/" in f.read().split()


def test_register_report_reads_ptxas_output():
    log = textwrap.dedent("""\
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112trace_kernelILb1ELi2ELi0ELb0EEEvNS_9TraceArgsE' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_112trace_kernelILb1ELi2ELi0ELb0EEEvNS_9TraceArgsE
            0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
        ptxas info    : Used 40 registers, used 0 barriers, 384 bytes cmem[0]
        ptxas info    : Function properties for _ZN12_GLOBAL__N_116propagate_kernelEPKjPKiPil
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 12 registers, used 0 barriers
        """)
    assert kernels.register_report(log) == [
        ("_ZN12_GLOBAL__N_112trace_kernelILb1ELi2ELi0ELb0EEEvNS_9TraceArgsE", 40, 4, 8),
        ("_ZN12_GLOBAL__N_116propagate_kernelEPKjPKiPil", 12, 0, 0)]


def test_check_takes_broadcast_rows_only_when_asked():
    one = torch.zeros(1, 3).expand(5, 3)
    kernels.check(one, "origins", torch.float32, (5, 3), broadcast_rows=True)
    with pytest.raises(ValueError):
        kernels.check(one, "origins", torch.float32, (5, 3))
    with pytest.raises(ValueError):
        kernels.check(torch.zeros(5, 6)[:, ::2], "origins", torch.float32, (5, 3),
                      broadcast_rows=True)
