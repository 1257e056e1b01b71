"""The port's app entry points on the CPU against the JAX package's:
``headless.render_scene`` (oracle backend equal; the device backend within
the repository's 0.5% pixel budget of JAX's tracer backend), the PNG writer
(decoded with PIL, the pixels of JAX's ``save_png``), and the CLI's
``render``, ``export``, ``genworld``, ``fly``, ``bench`` and an unknown
command. Scenes and assets are written by the tests from a seed."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from octree_tracer_tpu.app import headless as jheadless
from octree_tracer_tpu_torch import scenes
from octree_tracer_tpu_torch.app import cli, headless
from octree_tracer_tpu_torch.gen.procedural import Procedural
from octree_tracer_tpu_torch.io import load_file
from octree_tracer_tpu_torch.io.rsvo_export import save_rsvo
from octree_tracer_tpu_torch.io.vox_export import save_vox
from octree_tracer_tpu_torch.world.world import World

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = "0.4,0.6,-2.2:-0.2,-0.35,1.0"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A depth-6 shell as .vox and .rsvo, and a synthetic asset root."""
    d = tmp_path_factory.mktemp("scenes")
    shell = scenes.shell_chunk(6)
    (d / "shell.vox").write_bytes(save_vox(shell))
    (d / "shell.rsvo").write_bytes(save_rsvo(shell))
    root = scenes.write_asset_root(str(d / "assets"), seed=2)
    return {"vox": str(d / "shell.vox"), "rsvo": str(d / "shell.rsvo"), "assets": root,
            "dir": d}


def _run_cli(args, assets, cwd=REPO):
    env = dict(os.environ, OT_ASSET_ROOT=assets)
    out = subprocess.run([sys.executable, "-m", "octree_tracer_tpu_torch.app.cli", *args],
                         cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("kw", [{}, {"misc_bool": True}, {"show_steps": True},
                                {"shadows": False}])
def test_render_scene_oracle_equals_jax(files, kw):
    img, res = headless.render_scene(files["vox"], 40, 32, camera=CAMERA, backend="oracle",
                                     **kw)
    jimg, jres = jheadless.render_scene(files["vox"], 40, 32, camera=CAMERA,
                                        backend="oracle", **kw)
    np.testing.assert_array_equal(img, jimg)
    for k in ("hit", "index", "steps", "depth"):
        np.testing.assert_array_equal(res[k], jres[k])


def test_render_scene_device_within_budget_of_jax(files):
    """The port's device backend on the CPU (K3, K1 and K4's plain versions)
    against JAX's tracer backend on the same scene and camera, both as u8
    display frames: at most 0.5% of pixels differ; and within that budget of
    the port's own oracle backend."""
    img, res = headless.render_scene(files["rsvo"], 48, 40, camera=CAMERA, octree_depth=6,
                                     device="cpu")
    assert img.dtype == np.uint8 and img.shape == (40, 48, 3)
    assert isinstance(res.hit, torch.Tensor) and int(res.hit.sum()) > 100
    jimg, _ = jheadless.render_scene(files["rsvo"], 48, 40, camera=CAMERA, octree_depth=6,
                                     backend="tpu")
    oimg, _ = headless.render_scene(files["rsvo"], 48, 40, camera=CAMERA, octree_depth=6,
                                    backend="oracle")
    for other in (jimg, oimg):
        differ = np.any(img != headless.encode_u8(np.asarray(other)), axis=-1)
        assert differ.mean() < 0.005, f"{int(differ.sum())} pixels differ"


def test_render_scene_defaults_to_the_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        headless.render_scene(files["vox"], 8, 8)
    with pytest.raises(ValueError, match="backend"):
        headless.render_scene(files["vox"], 8, 8, backend="tpu", device="cpu")


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_png_decodes_to_jax_save_png_pixels(tmp_path, kind):
    """The standard-library PNG writer: PIL decodes it to the pixels PIL
    decodes from JAX's ``save_png`` of the same image, u8 and f32 input."""
    rng = np.random.default_rng(0)
    img = (rng.integers(0, 256, (13, 21, 3)).astype(np.uint8) if kind == "u8"
           else rng.uniform(-0.2, 1.2, (13, 21, 3)).astype(np.float32))
    headless.save_png(img, str(tmp_path / "port.png"))
    jheadless.save_png(img, str(tmp_path / "jax.png"))
    a = np.asarray(Image.open(tmp_path / "port.png"))
    b = np.asarray(Image.open(tmp_path / "jax.png"))
    assert a.shape == (13, 21, 3)
    np.testing.assert_array_equal(a, b)
    assert Image.open(io.BytesIO(headless.png_bytes(img))).format == "PNG"


def test_parse_camera_equals_jax():
    for spec in (None, CAMERA, "1,2,3:-1,0.5,0"):
        for a, b in zip(headless.parse_camera(spec), jheadless.parse_camera(spec)):
            np.testing.assert_array_equal(a, b)


def test_cli_render_oracle_and_device(files, tmp_path, capsys):
    """``render`` on the CPU writes the device frame (and the oracle's);
    the PNG is the u8 frame ``render_scene`` returns; launch counts are
    written (no kernel launches on the CPU)."""
    counts = tmp_path / "launches.json"
    out = str(tmp_path / "d.png")
    cli.main(["--launch-counts", str(counts), "render", files["rsvo"], "--depth", "6",
              "-o", out, "--width", "32", "--height", "24", "--camera", CAMERA,
              "--device", "cpu"])
    assert "hits)" in capsys.readouterr().out
    img, _ = headless.render_scene(files["rsvo"], 32, 24, camera=CAMERA, octree_depth=6,
                                   device="cpu")
    np.testing.assert_array_equal(np.asarray(Image.open(out)), img)
    assert json.loads(counts.read_text())["trace"] == 0
    cli.main(["render", files["vox"], "-o", str(tmp_path / "o.png"), "--width", "16",
              "--height", "16", "--oracle", "--show-steps"])
    assert np.asarray(Image.open(tmp_path / "o.png")).shape == (16, 16, 3)


def test_cli_export_round_trips(files, tmp_path, capsys):
    for ext in ("rsvo", "vox"):
        out = str(tmp_path / f"e.{ext}")
        cli.main(["export", files["vox"], "-o", out])
        assert "exported" in capsys.readouterr().out
        back = load_file(out, 6)
        ref = load_file(files["vox"])
        if ext == "vox":
            np.testing.assert_array_equal(back.to_words(), ref.to_words())
        else:
            assert save_rsvo(back) == save_rsvo(ref)


def test_cli_genworld_structures_equals_library_call(files, tmp_path):
    """``genworld --structures`` with ``OT_ASSET_ROOT`` set writes the
    files of ``World.generate_world`` with a Procedural on that root."""
    out = _run_cli(["genworld", str(tmp_path / "cli"), "--chunk-depth", "4",
                    "--structures", "--device", "cpu"], files["assets"])
    assert "8/8 chunks generated (" in out
    World(asset_root=files["assets"]).generate_world(
        str(tmp_path / "lib"), Procedural(chunk_depth=4, structures=True, device="cpu",
                                          asset_root=files["assets"]), world_depth=1)
    names = sorted(os.listdir(tmp_path / "lib"))
    assert sorted(os.listdir(tmp_path / "cli")) == names
    for f in names:
        assert (tmp_path / "cli" / f).read_bytes() == (tmp_path / "lib" / f).read_bytes()


def test_cli_fly_saves_lagged_frames(files, tmp_path):
    """``fly`` over a scene file with the block library: 3 frames, each
    saved one tick late and the last after the loop, u8 frames written
    verbatim."""
    out = _run_cli(["fly", files["vox"], "--frames", "3", "--width", "24", "--height",
                    "16", "-o", str(tmp_path / "fly_%d.png"), "--every", "1",
                    "--device", "cpu"], files["assets"])
    assert "frame 2:" in out
    assert "chunks loaded 0, evicted 0; deepest hit depth " in out
    for i in range(3):
        px = np.asarray(Image.open(tmp_path / f"fly_{i}.png"))
        assert px.shape == (16, 24, 3)
    assert np.unique(px).size > 2


def test_cli_bench_prints_jax_keys(files, capsys):
    cli.main(["bench", "--scene", files["rsvo"], "--depth", "6", "--frames", "1",
              "--width", "64", "--height", "48", "--no-shadows", "--device", "cpu"])
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("metric", "value", "unit", "frame_ms", "scene", "resolution", "shadows"):
        assert k in data
    assert data["unit"] == "Mrays/s" and data["shadows"] is False and data["frame_ms"] > 0
    # value is rays / time rounded to 0.01 (0.0 on a slow host), as JAX's
    assert abs(data["value"] - 64 * 48 / (data["frame_ms"] * 1e3)) <= 0.006


def test_cli_unknown_command():
    with pytest.raises(SystemExit):
        cli.main(["nope"])


def test_timing_utilities(tmp_path, monkeypatch):
    """FrameTimer and timed behave as JAX's; torch_trace writes a Chrome
    trace of the block under its directory."""
    from octree_tracer_tpu.utils import timing as jtiming
    from octree_tracer_tpu_torch.utils import FrameTimer, timed, torch_trace

    clock = iter(np.arange(0.0, 10.0, 0.25))
    monkeypatch.setattr("time.perf_counter", lambda: float(next(clock)))
    a, b = FrameTimer(window=3), jtiming.FrameTimer(window=3)
    for _ in range(5):
        assert a.tick() == b.tick()
    assert a.fps == b.fps == 2.0  # the two share the clock, 0.5 s a tick each
    lines = []
    with timed("x", sink=lines.append):
        pass
    assert lines == ["x: 250.0 ms"]
    monkeypatch.undo()
    with torch_trace(str(tmp_path / "trace")) as d:
        torch.ones(8).sum()
    (trace,) = (tmp_path / "trace").iterdir()
    assert d == str(tmp_path / "trace") and trace.suffix == ".json"
    assert "traceEvents" in json.loads(trace.read_text())
