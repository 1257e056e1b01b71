"""Interactive browser viewer (the JAX package's ``app/viewer.py``, on the
port's ``Session``): a standard-library HTTP server drives the streaming
Session, the page polls PNG frames and posts its input back, and the side
panel holds the reference's controls (sun direction, debug toggles, pause
adaptive, open a scene, regenerate the world; FPS and node/hole stats).

Frames are rendered on the card unless the Session was made on the CPU,
and written as PNG by ``headless.png_bytes`` (no image library).

    python -m octree_tracer_tpu_torch.app.viewer scene.vox [--port 8000]
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.timing import FrameTimer
from .headless import fetch_frame, png_bytes

_PAGE = """<!DOCTYPE html>
<html><head><title>octree-tracer-tpu</title><style>
body { background:#222; color:#ddd; font-family:monospace; display:flex; margin:0 }
#view { image-rendering:pixelated; width:70vw; cursor:crosshair }
#panel { padding:1em; width:26vw }
label { display:block; margin:4px 0 }
</style></head><body>
<img id="view" src="/frame.png">
<div id="panel">
  <h3>octree-tracer-tpu</h3>
  <div id="stats">...</div>
  <label><input type="checkbox" id="shadows" checked> Shadows</label>
  <label><input type="checkbox" id="show_steps"> Show ray steps</label>
  <label><input type="checkbox" id="show_hits"> Show ray hits</label>
  <label><input type="checkbox" id="pause_adaptive"> Pause adaptive</label>
  <label>Feedback every <input type="number" id="feedback_every" min="1" max="16" value="1" size="2"> frames</label>
  <label><input type="checkbox" id="deferred_feedback"> Deferred feedback (overlap readback)</label>
  <label><input type="checkbox" id="misc_bool"> Misc (&gt;= descent, gamma 1)</label>
  <label>Misc value <input type="range" id="misc_value" min="0" max="10" step="0.01" value="0"></label>
  <label>Octree depth <input type="range" id="octree_depth" min="0" max="20" value="12"
    oninput="document.getElementById('depthval').innerText=this.value">
    <span id="depthval">12</span></label>
  <label>FOV <input type="range" id="fov" min="30" max="120" value="90"></label>
  <label>Sun x <input type="range" id="sx" min="-3" max="3" step="0.1" value="-1.7"></label>
  <label>Sun y <input type="range" id="sy" min="-3" max="3" step="0.1" value="-1.0"></label>
  <label>Sun z <input type="range" id="sz" min="-3" max="3" step="0.1" value="0.8"></label>
  <p>WASD+Space/Shift move, drag to look,<br>scroll over image = speed</p>
  <input id="scenepath" placeholder="scene path or world dir" size="26">
  <button onclick="openScene()">Open</button>
  <button onclick="regen()">Regenerate world</button>
  <label><input type="checkbox" id="structs"> structures (trees/crystals)</label>
  <div id="openmsg"></div>
</div>
<script>
async function openScene() {
  const r = await fetch("/open", {method:"POST",
    body: JSON.stringify({path: document.getElementById("scenepath").value})});
  document.getElementById("openmsg").innerText = (await r.json()).message;
}
async function regen() {
  document.getElementById("openmsg").innerText = "generating...";
  const r = await fetch("/regenerate", {method:"POST", body: JSON.stringify(
    {structures: document.getElementById("structs").checked})});
  document.getElementById("openmsg").innerText = (await r.json()).message;
}
const keys = {};
onkeydown = e => keys[e.key.toLowerCase()] = true;
onkeyup = e => keys[e.key.toLowerCase()] = false;
let drag = null, look = [0, 0], wheel = 0;
const img = document.getElementById("view");
img.onmousedown = e => drag = [e.clientX, e.clientY];
onmouseup = () => drag = null;
onmousemove = e => { if (drag) { look[0] += e.clientX-drag[0]; look[1] += e.clientY-drag[1]; drag=[e.clientX, e.clientY]; } };
img.onwheel = e => { wheel += e.deltaY; e.preventDefault(); };
async function tick() {
  const body = {
    forward: (keys.w?1:0)-(keys.s?1:0), right: (keys.d?1:0)-(keys.a?1:0),
    up: (keys[" "]?1:0)-(keys.shift?1:0), look: look, wheel: wheel,
    shadows: document.getElementById("shadows").checked,
    show_steps: document.getElementById("show_steps").checked,
    show_hits: document.getElementById("show_hits").checked,
    pause_adaptive: document.getElementById("pause_adaptive").checked,
    feedback_every: +document.getElementById("feedback_every").value,
    deferred_feedback: document.getElementById("deferred_feedback").checked,
    misc_bool: document.getElementById("misc_bool").checked,
    misc_value: +document.getElementById("misc_value").value,
    octree_depth: +document.getElementById("octree_depth").value,
    fov: +document.getElementById("fov").value,
    sun: [+document.getElementById("sx").value, +document.getElementById("sy").value, +document.getElementById("sz").value],
  };
  look = [0, 0]; wheel = 0;
  const r = await fetch("/step", {method:"POST", body: JSON.stringify(body)});
  const stats = await r.json();
  document.getElementById("stats").innerText =
    `FPS: ${stats.fps.toFixed(1)}  nodes: ${(stats.nodes/1e6).toFixed(2)}M (${stats.holes.toFixed(0)}% holes)` +
    `  +${stats.subdivided}/-${stats.collapsed}`;
  img.src = "/frame.png?" + Date.now();
  setTimeout(tick, 30);
}
tick();
</script></body></html>"""


class ViewerServer:
    """Owns the session and the latest frame; the handlers call into it."""

    def __init__(self, session):
        self.session = session
        self.timer = FrameTimer()
        self.lock = threading.Lock()
        self.frame_png = b""
        self.last_stats = {"subdivided": 0, "collapsed": 0, "patched": 0}
        self._pending = None
        self._render(sync=True)

    def _render(self, sync=False):
        """Step the session once and publish a frame as PNG.

        Steady-state ticks are double-buffered: the frame published is the
        previous tick's, whose copy to the host (``fetch_frame``: pinned
        memory and an event on the card) overlapped this tick's step; its
        stats ride with it. ``sync=True`` (start-up, scene swaps) publishes
        this step's frame and drops any pending one from the old scene."""
        img, _, stats = self.session.step()
        frame = (fetch_frame(img), stats)
        show, self._pending = self._pending, frame
        if sync:
            show, self._pending = frame, None
        elif show is None:
            show = frame  # pipeline fill: publish this frame too
        fetch, self.last_stats = show
        self.frame_png = png_bytes(fetch())
        self.timer.tick()

    def open_scene(self, path: str) -> str:
        """Swap in a scene file or a saved world (the reference's Open File
        / Open World buttons)."""
        import os

        from ..io import load_file
        from ..world.world import World

        with self.lock:
            try:
                if os.path.isdir(path):
                    self.session.reset_world(
                        World.load_world(path, asset_root=self.session.world.asset_root))
                else:
                    chunk = load_file(path, self.session.settings.octree_depth)
                    self.session.reset_scene(chunk)
                self._render(sync=True)
                return f"loaded {path}"
            except Exception as e:  # shown in the panel, as the egui error label
                return f"error: {e}"

    def regenerate(self, chunk_depth: int | None = None,
                   structures: bool = False,
                   world_depth: int = 1) -> str:
        """Regenerate the procedural world into the current world's
        directory (or ``ot_tpu_world`` in the temporary directory), on the
        session's device with its world's asset root, and reset the
        streamed octree (the reference's Regenerate button)."""
        import os
        import tempfile

        from ..gen.procedural import Procedural
        from ..world.world import World

        with self.lock:
            try:
                path = self.session.world.path or os.path.join(
                    tempfile.gettempdir(), "ot_tpu_world"
                )
                asset_root = self.session.world.asset_root
                world = World(path, asset_root=asset_root, load_blocks=True)
                proc = Procedural(
                    chunk_depth=chunk_depth if chunk_depth is not None else 9,
                    structures=structures, device=self.session.device,
                    asset_root=asset_root,
                )
                world.generate_world(path, proc, world_depth=world_depth)
                self.session.reset_world(world)
                self._render(sync=True)
                return f"regenerated world at {path}"
            except Exception as e:
                return f"error: {e}"

    def step(self, inp: dict) -> dict:
        with self.lock:
            s = self.session
            st = s.settings
            st.shadows = bool(inp.get("shadows", True))
            st.show_steps = bool(inp.get("show_steps", False))
            st.show_hits = bool(inp.get("show_hits", False))
            st.pause_adaptive = bool(inp.get("pause_adaptive", False))
            st.feedback_every = max(
                1, int(inp.get("feedback_every", st.feedback_every))
            )
            st.deferred_feedback = bool(
                inp.get("deferred_feedback", st.deferred_feedback)
            )
            st.misc_bool = bool(inp.get("misc_bool", False))
            st.misc_value = float(inp.get("misc_value", st.misc_value))
            # Import depth for the next Open (reference slider 0..=20,
            # src/app.rs:257-260).
            st.octree_depth = int(inp.get("octree_depth", st.octree_depth))
            st.fov = float(inp.get("fov", st.fov))
            st.sun_dir = np.asarray(
                inp.get("sun", st.sun_dir), dtype=np.float32
            )
            s.character.speed += float(inp.get("wheel", 0.0)) / 200.0
            s.character.move(
                forward=float(inp.get("forward", 0.0)),
                right=float(inp.get("right", 0.0)),
                up=float(inp.get("up", 0.0)),
            )
            lx, ly = inp.get("look", (0.0, 0.0))
            if lx or ly:
                s.character.turn(
                    float(lx) * 8.0, float(ly) * 8.0,
                    sensitivity=st.sensitivity, fov=st.fov,
                )
            self._render()
            nodes, holes = s.node_stats()
            return {
                "fps": self.timer.fps,
                "nodes": nodes,
                "holes": holes,
                **self.last_stats,
            }


def make_handler(server: ViewerServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                self._send(200, "image/png", server.frame_png)
            else:
                self._send(200, "text/html", _PAGE.encode())

        def do_POST(self):
            if self.path == "/step":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    inp = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, "text/plain", b"bad json")
                    return
                stats = server.step(inp)
                self._send(200, "application/json", json.dumps(stats).encode())
            elif self.path == "/regenerate":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    inp = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, "text/plain", b"bad json")
                    return
                msg = server.regenerate(
                    chunk_depth=inp.get("chunk_depth"),
                    structures=bool(inp.get("structures", False)),
                    world_depth=int(inp.get("world_depth", 1)),
                )
                self._send(
                    200, "application/json",
                    json.dumps({"message": msg}).encode(),
                )
            elif self.path == "/open":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    inp = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, "text/plain", b"bad json")
                    return
                msg = server.open_scene(str(inp.get("path", "")))
                self._send(
                    200, "application/json",
                    json.dumps({"message": msg}).encode(),
                )
            else:
                self._send(404, "text/plain", b"")

    return Handler


def serve(session, port: int = 8000):
    server = ViewerServer(session)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(server))
    print(f"viewer at http://127.0.0.1:{port}/")
    httpd.serve_forever()


def main(argv=None):
    import argparse

    from .cli import open_world
    from .session import Session

    p = argparse.ArgumentParser()
    p.add_argument("scene", help=".vox/.rsvo file or world directory")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the card, default) or cpu")
    args = p.parse_args(argv)
    session = Session(open_world(args.scene, args.depth), width=args.width,
                      height=args.height, device=args.device)
    serve(session, args.port)


if __name__ == "__main__":
    main()
