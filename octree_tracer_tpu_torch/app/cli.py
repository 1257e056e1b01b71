"""Command-line interface (the JAX package's ``app/cli.py``, on the card):

  render    one frame of a .vox/.rsvo scene -> PNG
  fly       adaptive streaming fly-through of a scene or saved world
  view      interactive browser viewer
  genworld  procedurally generate and save a world
  export    write a scene back out as .rsvo (or .vox)
  bench     throughput benchmark

The flags and defaults are JAX's. The port adds ``--device`` to every
command that renders or generates, the card (``cuda``) by default; ``cpu``
runs the plain PyTorch versions. Without a card the default raises. A
global ``--launch-counts PATH``, a measurement hook for ``chip_smoke.py``,
writes each kernel's launches in the run to PATH as JSON when the command
ends. The block library, structures and ``bench``'s default scene
(``files/monu10.vox``) are read under ``OT_ASSET_ROOT``.

    python -m octree_tracer_tpu_torch.app.cli render scene.vox -o frame.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def cmd_render(args):
    from .headless import render_scene, save_png

    img, result = render_scene(
        args.scene,
        width=args.width, height=args.height, fov=args.fov,
        camera=args.camera,
        sun_dir=tuple(float(x) for x in args.sun.split(",")),
        shadows=not args.no_shadows,
        show_steps=args.show_steps,
        show_hits=args.show_hits,
        misc_bool=args.misc,
        octree_depth=args.depth,
        backend="oracle" if args.oracle else "device",
        device=args.device,
    )
    save_png(img, args.output)
    hit = result["hit"] if isinstance(result, dict) else result.hit
    print(f"rendered {args.scene} -> {args.output} ({int(hit.sum())} hits)")


def open_world(scene: str, depth: int):
    """A saved world directory, or a scene file as chunk 0 of a World with
    the block library (JAX ``cmd_fly``)."""
    from ..io import load_file
    from ..world.world import World

    if os.path.isdir(scene):
        return World.load_world(scene)
    world = World()
    world.chunks[0] = load_file(scene, depth)
    world.generate_mip_tree(0)
    return world


def cmd_fly(args):
    import torch

    from .headless import fetch_frame, save_png
    from .session import Session

    world = open_world(args.scene, args.depth)
    session = Session(world, width=args.width, height=args.height, device=args.device)
    session.settings.shadows = not args.no_shadows
    session.settings.feedback_every = max(1, args.feedback_every)
    pending = None  # (frame index, fetch): saved one tick late, so the
    # frame's copy to the host overlaps the next frame's work
    resident, loads, evictions, deepest = set(world.chunks), 0, 0, None
    for i in range(args.frames):
        t0 = time.time()
        img, result, stats = session.step()
        # The deepest hit so far (step-cap hits report the cap, not a depth),
        # kept on the device: read once, at the end.
        frame_deepest = torch.where(result.hit & ~result.forced, result.depth, 0).max()
        deepest = frame_deepest if deepest is None else torch.maximum(deepest, frame_deepest)
        session.character.move(forward=args.speed)
        dispatch_ms = 1e3 * (time.time() - t0)
        if pending is not None:
            j, fetch = pending
            save_png(fetch(), args.output.replace("%d", str(j)))
            pending = None
        if args.output and (i % args.every == 0 or i == args.frames - 1):
            pending = (i, fetch_frame(img))
        tick_ms = 1e3 * (time.time() - t0)
        now = set(world.chunks)
        loads, evictions, resident = (loads + len(now - resident),
                                      evictions + len(resident - now), now)
        nodes, holes = session.node_stats()
        # "tick" = dispatch + the previous frame's overlapped fetch and save.
        timing = (f"{tick_ms:.0f} ms tick ({dispatch_ms:.0f} dispatch)"
                  if args.output else f"{tick_ms:.0f} ms")
        print(
            f"frame {i}: {timing}, "
            f"+{stats['subdivided']} -{stats['collapsed']} nodes, "
            f"pool {nodes / 1e6:.2f}M ({holes:.0f}% holes)"
        )
    if pending is not None:
        j, fetch = pending
        save_png(fetch(), args.output.replace("%d", str(j)))
    print(f"chunks loaded {loads}, evicted {evictions}; deepest hit depth "
          f"{0 if deepest is None else int(deepest)}")


def cmd_genworld(args):
    from ..gen.procedural import Procedural
    from ..world.world import World

    world = World(verbose=True)
    proc = Procedural(chunk_depth=args.chunk_depth, structures=args.structures,
                      device=args.device)
    def progress(i, n):
        t = proc.timings[-1]
        print(f"{i}/{n} chunks generated (grid wait {t['wait_s']:.3f} s, build "
              f"{t['build_s']:.3f} s, stamp {t['stamp_s']:.3f} s, {t['stamped']} blocks "
              f"stamped, {t['nodes']} nodes)")

    t0 = time.time()
    world.generate_world(args.dir, proc, world_depth=args.world_depth, progress=progress)
    print(f"world written to {args.dir} in {time.time() - t0:.0f}s")


def cmd_bench(args):
    import torch

    from .. import kernels
    from ..io import load_file
    from ..render import tracer
    from ..render.camera import camera_matrices, generate_rays_device
    from ..state import u32_to_device
    from ..world.world import resolve_asset_root
    from .headless import parse_camera

    dev = kernels.resolve_device(args.device)
    scene = args.scene or os.path.join(resolve_asset_root(), "files", "monu10.vox")
    tree = load_file(scene, args.depth)
    words = u32_to_device(tree.to_words(), dev)
    pos, look = parse_camera(args.camera or "0.4,0.6,-2.2:-0.2,-0.35,1.0")
    _, cam_inv = camera_matrices(pos, look, args.fov, args.width, args.height)
    origin, dirs = generate_rays_device(cam_inv, args.width, args.height, dev)

    def frame():
        _, res, _ = tracer.render_frame(words, origin, dirs, shadows=not args.no_shadows)
        return res.hit

    # Each frame's hit mask is read back to the host, as JAX's command reads
    # it: the time per frame includes that copy and its synchronisation.
    frame().cpu()  # warm-up: builds the kernels, sizes the allocator
    t0 = time.time()
    for _ in range(args.frames):
        r = frame().cpu()
    dt = (time.time() - t0) / args.frames
    rays = args.width * args.height * (2 if not args.no_shadows else 1)
    mrays = rays / dt / 1e6
    print(json.dumps({
        "metric": "Mrays/s",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "frame_ms": round(dt * 1e3, 1),
        "scene": scene,
        "resolution": f"{args.width}x{args.height}",
        "shadows": not args.no_shadows,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "hits": int(r.sum()),
    }))


def cmd_view(args):
    from .viewer import main as viewer_main

    viewer_main([
        args.scene, "--port", str(args.port), "--width", str(args.width),
        "--height", str(args.height), "--depth", str(args.depth),
        "--device", args.device,
    ])


def cmd_export(args):
    from ..io import load_file

    tree = load_file(args.scene, args.depth)
    if args.output.lower().endswith(".vox"):
        # Black #000000 voxels are not representable in the octree encoding
        # (payload VOXEL_OFFSET + 0 is empty) and are dropped.
        from ..io.vox_export import save_vox

        data = save_vox(tree)
    else:
        from ..io.rsvo_export import save_rsvo

        data = save_rsvo(tree)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"exported {args.scene} -> {args.output} ({len(data)} bytes)")


def _add_device(sp):
    sp.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card, default) or cpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="octree-tracer-tpu-torch")
    p.add_argument("--launch-counts", metavar="PATH", default=None,
                   help="measurement hook for chip_smoke.py: write each kernel's "
                        "launches in this run to PATH as JSON")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("--width", type=int, default=512)
        sp.add_argument("--height", type=int, default=512)
        sp.add_argument("--fov", type=float, default=90.0)
        sp.add_argument("--camera", default=None,
                        help="px,py,pz:lx,ly,lz")
        sp.add_argument("--depth", type=int, default=12,
                        help="octree import depth for .rsvo")
        sp.add_argument("--no-shadows", action="store_true")
        _add_device(sp)

    sp = sub.add_parser("render", help="render one frame to PNG")
    sp.add_argument("scene")
    sp.add_argument("-o", "--output", default="frame.png")
    sp.add_argument("--sun", default="-1.7,-1.0,0.8")
    sp.add_argument("--show-steps", action="store_true")
    sp.add_argument("--show-hits", action="store_true")
    sp.add_argument("--misc", action="store_true",
                    help=">= descent comparisons + gamma 1.0 (reference misc)")
    sp.add_argument("--oracle", action="store_true",
                    help="use the NumPy reference tracer")
    add_common(sp)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("fly", help="adaptive streaming fly-through")
    sp.add_argument("scene", help=".vox/.rsvo file or world directory")
    sp.add_argument("--frames", type=int, default=30)
    sp.add_argument("--speed", type=float, default=1.0)
    sp.add_argument("-o", "--output", default=None,
                    help="PNG path; %%d is replaced by the frame index")
    sp.add_argument("--every", type=int, default=10)
    sp.add_argument("--feedback-every", type=int, default=1,
                    help="count visits + adapt LOD every Nth frame")
    add_common(sp)
    sp.set_defaults(fn=cmd_fly)

    sp = sub.add_parser("view", help="interactive browser viewer")
    sp.add_argument("scene")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--width", type=int, default=480)
    sp.add_argument("--height", type=int, default=360)
    sp.add_argument("--depth", type=int, default=12)
    _add_device(sp)
    sp.set_defaults(fn=cmd_view)

    sp = sub.add_parser("export", help="write a scene as .rsvo")
    sp.add_argument("scene")
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("--depth", type=int, default=12)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("genworld", help="generate a procedural world")
    sp.add_argument("dir")
    sp.add_argument("--world-depth", type=int, default=1)
    sp.add_argument("--chunk-depth", type=int, default=9)
    sp.add_argument("--structures", action="store_true",
                    help="stamp trees/crystals on generated grass")
    _add_device(sp)
    sp.set_defaults(fn=cmd_genworld)

    sp = sub.add_parser("bench", help="throughput benchmark")
    sp.add_argument("--scene", default=None,
                    help="scene file (default: files/monu10.vox under OT_ASSET_ROOT, "
                         "as JAX's default lies in its asset root)")
    sp.add_argument("--frames", type=int, default=5)
    sp.add_argument("--tile-size", type=int, default=64 * 1024,
                    help="ignored: accepted as the JAX CLI accepts it; the port "
                         "traces a frame in one launch, with no tiles")
    add_common(sp)
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    finally:
        if args.launch_counts:
            from .. import kernels

            with open(args.launch_counts, "w") as f:
                json.dump(kernels.LAUNCHES, f)


if __name__ == "__main__":
    sys.exit(main())
