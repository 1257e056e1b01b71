"""Rank functions of ``tests/test_torch_parallel.py``.

Each runs in a rank process that ``parallel.launch.run_ranks`` spawns, which
imports this module by name: so it imports the port only, never JAX or the
JAX package, and returns NumPy arrays and plain values.
"""

import hashlib

import numpy as np
import torch

from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.parallel import ShardedSession, render_frame_sharded, replicate
from octree_tracer_tpu_torch.render import camera, skip, tracer

LEVELS = 7  # the Session's combined table
CAMERAS = {
    # the bench's generic cameras (bench.py:255-257 and its deep10 row)
    "bench": (np.array([0.4, 0.6, -2.2], np.float32), np.array([-0.2, -0.35, 1.0], np.float32)),
    # inside the root cube: exact interior counts under a table (test_torch_visits.py)
    "inside": (np.array([-0.35, 0.55, -0.6], np.float32),
               np.array([0.3, -0.5, 1.0], np.float32)),
}
SCENES = {"shell6": lambda: scenes.deep_shell(6), "random6": lambda: scenes.random_scene(6, 1500, 3)}
# (scene, width, height, camera, table)
FRAME_CASES = {
    "shell6-32x32-bench": ("shell6", 32, 32, "bench", False),
    "shell6-32x32-bench-L7": ("shell6", 32, 32, "bench", True),
    "random6-32x32-inside": ("random6", 32, 32, "inside", False),
    "random6-32x32-inside-L7": ("random6", 32, 32, "inside", True),
    # 6 rows a rank at 4 ranks, as 1080p's 270: K1's 8x4 tiles clip
    "random6-40x24-inside-L7": ("random6", 40, 24, "inside", True),
}
MODES = {
    "image": {},
    "counts": dict(with_visits=True),
    "flags": dict(with_visits=True, visit_flags=True),
    "show_hits": dict(show_hits=True),
}
SESSION_RES, SESSION_STEPS, SESSION_TURN = 32, 11, 7
SESSION_POS = np.array([0.25, 0.35, -2.3], np.float32)
SESSION_LOOK = np.array([-0.12, -0.17, 1.0], np.float32)
SESSION_CONFIGS = {
    "defaults": {},
    "sync_fb2_warp": dict(deferred_feedback=False, feedback_every=2, warp_pool_words=1),
    "deferred_fb2": dict(feedback_every=2, deferred_feedback=True),
}


def rays(cam, width, height, device="cpu"):
    pos, look = CAMERAS[cam]
    ci = camera.camera_matrices(pos, look, 70.0, width, height)[1]
    return camera.generate_rays_device(ci, width, height, device)


def table_words(scene) -> np.ndarray:
    words = state.u32_to_device(SCENES[scene](), "cpu")
    return state.to_numpy_u32(skip.build_warp_skip_table(words, LEVELS))


def _digest(t) -> str:
    if t is None:
        return "none"
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def frames(mesh) -> dict:
    """Every frame case in every mode through ``render_frame_sharded``; the
    pool and the table reach ranks 1.. by ``replicate``. Then the uneven
    heights: a frame and a ShardedSession whose height does not divide."""
    torch.set_num_threads(1)
    out = {}
    pools, tables = {}, {}
    for case, (scene, w, h, cam, table) in FRAME_CASES.items():
        if scene not in pools:
            words = state.u32_to_device(SCENES[scene](), "cpu") if mesh.rank == 0 else None
            pools[scene] = replicate(mesh, words)
            tab = (skip.build_warp_skip_table(pools[scene], LEVELS)
                   if mesh.rank == 0 else None)
            tables[scene] = replicate(mesh, tab)
        words = pools[scene]
        origin, dirs = rays(cam, w, h)
        for mode, kw in MODES.items():
            img, res, visits = render_frame_sharded(
                mesh, words, origin, dirs, u8_image=mode != "show_hits",
                warp_table=tables[scene] if table else None, **kw)
            out[case, mode] = (img.numpy(), tracer.to_numpy(res),
                               None if visits is None else visits.numpy())
    uneven = []
    if mesh.size > 1:
        h = 8 * mesh.size + 1
        origin, dirs = rays("bench", 16, h)
        for call in (lambda: render_frame_sharded(mesh, pools["shell6"], origin, dirs),
                     lambda: ShardedSession(None, mesh, 16, h, pool_capacity=65536)):
            try:
                call()
                uneven.append(False)
            except ValueError:
                uneven.append(True)
    return {"frames": out, "uneven": uneven, "traffic": mesh.traffic}


# The JAX frame's schedules through the sharded frame: (case, mode) ->
# render_frame_sharded's keywords.
SCHEDULE_FRAMES = {
    ("random6-32x32-inside", "tiled-beams8"): dict(mode="tiled", beams=8, with_visits=True),
    ("random6-32x32-inside", "staged-beams8"): dict(mode="staged", beams=8, with_visits=True),
    ("random6-32x32-inside-L7", "staged-beams8-flags"): dict(
        mode="staged", beams=8, with_visits=True, visit_flags=True),
    ("random6-32x32-inside-L7", "beam-flags"): dict(mode="beam", with_visits=True,
                                                     visit_flags=True),
    ("shell6-32x32-bench", "beam"): dict(mode="beam", tile_size=None),
}


def schedule_frames(mesh) -> dict:
    """Each ``SCHEDULE_FRAMES`` call through ``render_frame_sharded``."""
    torch.set_num_threads(1)
    out = {}
    for (case, mode), kw in SCHEDULE_FRAMES.items():
        scene, w, h, cam, table = FRAME_CASES[case]
        words = state.u32_to_device(SCENES[scene](), "cpu")
        tab = skip.build_warp_skip_table(words, LEVELS) if table else None
        origin, dirs = rays(cam, w, h)
        img, res, visits = render_frame_sharded(mesh, words, origin, dirs, u8_image=True,
                                                warp_table=tab, **kw)
        out[case, mode] = (img.numpy(), tracer.to_numpy(res),
                           None if visits is None else visits.numpy())
    return out


def session_lockstep(mesh, world_chunks) -> dict:
    """Each configuration of ``SESSION_CONFIGS`` for ``SESSION_STEPS`` steps,
    turning at ``SESSION_TURN``; rank 0 streams from ``world_chunks``. Per
    step: the image, stats, node_stats and selection offset, the pool (rank
    0) and the digests of every rank's pool and table."""
    torch.set_num_threads(1)
    out = {}
    for config, settings in SESSION_CONFIGS.items():
        world = state.world_from_numpy(world_chunks) if mesh.rank == 0 else None
        s = ShardedSession(world, mesh, SESSION_RES, SESSION_RES, pool_capacity=65536)
        s.character.pos, s.character.look = SESSION_POS.copy(), SESSION_LOOK.copy()
        s.settings.fov = 70.0
        for k, v in settings.items():
            setattr(s.settings, k, v)
        steps = []
        for i in range(SESSION_STEPS):
            if i == SESSION_TURN:
                s.character.turn(900.0, 300.0, fov=70.0)
            img, res, stats = s.step()
            steps.append({
                "img": img.numpy(), "hit": res.hit.numpy(), "stats": stats,
                "node_stats": s.node_stats(), "sel_offset": s._sel_offset,
                "pool": state.to_numpy_u32(s.device_words) if mesh.rank == 0 else None,
                "pool_digest": _digest(s.device_words),
                "table_digest": _digest(s._warp_table),
            })
        out[config] = {
            "steps": steps, "stale_dropped": s.stale_dropped,
            "warp_incremental": getattr(s, "_warp_incremental", None),
            "table": s._warp_table is not None,
        }
    return out


def fail_on_rank(mesh, rank):
    """Rank ``rank`` raises; the others wait for it in a barrier."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return mesh.rank
