"""The port's viewer on a CPU Session: JAX's ``tests/test_viewer.py`` cases
(stepping, toggles, scene swaps, the depth slider, the one-tick double
buffer, Regenerate) on scenes and an asset root written here, and one HTTP
round trip through ``make_handler`` on port 0."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from octree_tracer_tpu.app.viewer import _PAGE as JPAGE
from octree_tracer_tpu_torch import scenes
from octree_tracer_tpu_torch.app.session import Session
from octree_tracer_tpu_torch.app.viewer import _PAGE, ViewerServer, make_handler
from octree_tracer_tpu_torch.io import load_file
from octree_tracer_tpu_torch.io.rsvo_export import save_rsvo
from octree_tracer_tpu_torch.io.vox_export import save_vox
from octree_tracer_tpu_torch.world.world import World


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A small random scene and a depth-7 shell as .vox, and an asset root."""
    d = tmp_path_factory.mktemp("viewer")
    small = scenes.chunk_from_words(scenes.random_scene(3, 45, 4))
    (d / "small.vox").write_bytes(save_vox(small))
    (d / "shell.vox").write_bytes(save_vox(scenes.shell_chunk(7)))
    root = scenes.write_asset_root(str(d / "assets"), seed=1)
    return {"small": str(d / "small.vox"), "shell": str(d / "shell.vox"), "assets": root,
            "dir": d}


@pytest.fixture(scope="module")
def server(files):
    world = World(load_blocks=False)
    world.chunks[0] = load_file(files["small"])
    world.generate_mip_tree(0)
    session = Session(world, width=32, height=32, pool_capacity=65536, device="cpu")
    return ViewerServer(session)


def _png_shape(data: bytes):
    import io

    return np.asarray(Image.open(io.BytesIO(data))).shape


def test_initial_frame(server):
    assert server.frame_png.startswith(b"\x89PNG")
    assert _png_shape(server.frame_png) == (32, 32, 3)


def test_step_moves_and_reports(server):
    stats = server.step({"forward": 1.0, "look": [5, 0]})
    assert stats["nodes"] >= 8
    assert "subdivided" in stats and "fps" in stats
    assert server.frame_png.startswith(b"\x89PNG")


def test_step_toggles(server):
    server.step({"show_steps": True, "pause_adaptive": True})
    assert server.session.settings.show_steps
    assert server.session.settings.pause_adaptive
    server.step({})  # back to the defaults
    assert not server.session.settings.show_steps


def test_open_scene_error_surfaces(server, files):
    assert server.open_scene(str(files["dir"] / "missing.vox")).startswith("error:")


def test_open_scene_swaps(server, files):
    msg = server.open_scene(files["shell"])
    assert msg.startswith("loaded")
    assert len(server.session.world.chunks[0]) > 1000
    assert len(server.session.octree) >= 8


def test_page_is_jax_page():
    assert _PAGE == JPAGE
    for control in ("shadows", "show_steps", "show_hits", "pause_adaptive",
                    "misc_bool", "fov", "sx", "scenepath"):
        assert f'id="{control}"' in _PAGE


def test_depth_slider_and_misc_value(server, files, tmp_path):
    """The depth slider sets the import depth of the next Open (it cuts
    .rsvo imports); misc_value is kept."""
    server.step({"octree_depth": 3, "misc_value": 2.5})
    st = server.session.settings
    assert st.octree_depth == 3 and st.misc_value == 2.5
    rsvo = tmp_path / "shell.rsvo"
    rsvo.write_bytes(save_rsvo(load_file(files["shell"])))
    assert server.open_scene(str(rsvo)).startswith("loaded")
    assert len(server.session.world.chunks[0]) <= 8 * (1 + 8 + 64)
    server.step({"octree_depth": 12})


def test_double_buffered_ticks_lag_one_frame(server, files):
    """Steady-state ticks publish the previous tick's frame; a scene swap
    publishes its own frame and drops the pending one."""
    server.open_scene(files["shell"])
    assert server._pending is None
    server.step({})  # first pipelined tick: shows its own frame, arms pending
    assert server._pending is not None
    png_a = server.frame_png
    server.step({"look": [40, 0]})  # shows the previous (pre-turn) frame
    assert server.frame_png == png_a
    server.step({})  # now the post-turn frame surfaces
    assert server.frame_png != png_a
    assert server.open_scene(files["small"]).startswith("loaded")
    assert server._pending is None
    assert server.frame_png.startswith(b"\x89PNG")


def test_regenerate_button(files, tmp_path):
    """Regenerate: a new procedural world with the block library and
    structures, from the current world's asset root, on the session's
    device; the octree resets."""
    world = World(asset_root=files["assets"])
    world.path = str(tmp_path / "world")
    world.chunks[0] = load_file(files["small"])
    world.generate_mip_tree(0)
    session = Session(world, width=16, height=16, pool_capacity=65536, device="cpu")
    srv = ViewerServer(session)
    msg = srv.regenerate(chunk_depth=4, structures=True, world_depth=1)
    assert msg.startswith("regenerated"), msg
    assert 0 in srv.session.world.chunks and 8 in srv.session.world.chunks
    assert len(srv.session.octree) >= 8
    assert srv.frame_png.startswith(b"\x89PNG")
    assert (tmp_path / "world" / "0.bin").exists()


def test_http_round_trip(server, files):
    """The handler on 127.0.0.1, port 0: the page, a frame, a step, an
    Open, a bad body and an unknown path."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()

    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert r.status == 200 and b"octree-tracer-tpu" in r.read()
        with urllib.request.urlopen(base + "/frame.png?1", timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
            assert _png_shape(r.read()) == (32, 32, 3)
        status, body = post("/step", json.dumps({"forward": 0.5, "shadows": False}).encode())
        assert status == 200 and "nodes" in json.loads(body)
        status, body = post("/open", json.dumps({"path": files["small"]}).encode())
        assert status == 200 and json.loads(body)["message"].startswith("loaded")
        for path, body, code in (("/step", b"{not json", 400), ("/nope", b"{}", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(path, body)
            assert e.value.code == code
    finally:
        httpd.shutdown()
        httpd.server_close()
