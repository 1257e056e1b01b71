"""The multi-rank dry run (the port of the JAX package's
``__graft_entry__.dryrun_multichip``): the whole sharded step on a group of
rank processes, with the step's collective volumes as measured.

``dryrun_multichip(n_ranks, device)`` starts ``n_ranks`` ranks
(``launch.run_ranks``: NCCL with a card a rank, gloo when ranks share a
card or on ``"cpu"``) and on each runs:

- two ``ShardedSession.step``s over the depth-6 shell world
  (``scenes.shell_world``) that grow the tree: sharded render, summed
  visits, K5 and the host engine on rank 0, and the step message that
  replays its patches on every rank;
- a raw ``render_frame_sharded`` of the depth-6 shell with visits, then
  ``select_candidates_packed`` and ``apply_patches`` on its result.

It checks that every rank returned the same frames and pool, prints the
pool bucket, the visit all-reduce, the largest step payload (patches), the
candidate readback and the frame all-gather, each as this run moved it, and
returns them. It projects no time.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .launch import run_ranks

RES = 64  # divides by 1, 2, 4, 8, 16, 32 and 64 ranks
DEPTH = 6
STEPS = 2
POS = np.array([0.25, 0.35, -2.3], np.float32)
LOOK = np.array([-0.12, -0.17, 1.0], np.float32)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dryrun_rank(mesh) -> dict:
    from .. import scenes, state
    from ..adaptive import feedback
    from ..render import camera
    from . import mesh as pmesh
    from .session import ShardedSession

    world = scenes.shell_world(DEPTH) if mesh.rank == 0 else None
    session = ShardedSession(world, mesh, width=RES, height=RES, pool_capacity=65536)
    session.character.pos, session.character.look = POS.copy(), LOOK.copy()
    session.settings.fov = 70.0
    mesh.traffic.clear()  # the steps' traffic only
    grown, digests, readback = 0, [], 0
    for _ in range(STEPS):
        img, result, stats = session.step()
        if tuple(img.shape) != (RES, RES, 3) or result.hit.shape[0] != RES * RES:
            raise AssertionError(f"frame of shape {tuple(img.shape)}")
        grown += stats["subdivided"]
        digests.append(_digest(img, session.device_words))
        if session._pending_feedback is not None:  # rank 0: the packed lists
            readback = session._pending_feedback[0].numel() * 4
    if grown == 0:
        raise AssertionError("the sharded steps subdivided nothing")
    steps = {k: dict(v) for k, v in mesh.traffic.items()}

    words = pmesh.replicate(mesh, state.u32_to_device(scenes.deep_shell(DEPTH), mesh.device)
                            if mesh.rank == 0 else None)
    ci = camera.camera_matrices(POS, LOOK, 70.0, RES, RES)[1]
    origin, dirs = camera.generate_rays_device(ci, RES, RES, mesh.device)
    img, result, visits = pmesh.render_frame_sharded(mesh, words, origin, dirs,
                                                     with_visits=True)
    if int(visits.sum()) <= 0:
        raise AssertionError("the sharded frame counted no visit")
    packed = feedback.select_candidates_packed(words, visits, words.shape[0],
                                               sub_cap=255, unsub_cap=255)
    patched = feedback.apply_patches(words, np.array([0, -1], np.int32),
                                     np.array([(134217728 + 0xFF) << 4, 0], np.uint32))
    if patched.shape != words.shape or packed.shape[0] != 2 + 255 + 255:
        raise AssertionError("select_candidates_packed or apply_patches gave bad shapes")
    digests.append(_digest(img, visits, packed, patched))
    return {"rank": mesh.rank, "digests": digests, "traffic": steps,
            "bucket": int(session.device_words.shape[0]), "nodes": session.node_stats()[0],
            "grown": grown, "readback": readback}


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """Run the sharded step on ``n_ranks`` rank processes on ``device``
    (``"cuda"`` or ``"cpu"``); print and return the step's collective
    volumes. Raises if a rank fails or the ranks disagree."""
    if RES % n_ranks:
        raise ValueError(f"{RES} rows do not divide by {n_ranks} ranks")
    ranks = run_ranks(_dryrun_rank, n_ranks, device)
    first = ranks[0]
    for r in ranks[1:]:
        if r["digests"] != first["digests"]:
            raise AssertionError(f"rank {r['rank']}'s frames or pool differ from rank 0's")
    t = first["traffic"]
    out = {
        "ranks": n_ranks, "device": str(device), "bucket_words": first["bucket"],
        "nodes": first["nodes"], "subdivided": first["grown"],
        "visits_all_reduce_mb": t["visits"]["max_bytes"] / 1e6,
        "largest_step_payload_kb": t.get("message_payload", {}).get("max_bytes", 0) / 1e3,
        "candidate_readback_kb": first["readback"] / 1e3,
        "frame_all_gather_mb": t["frame_gather"]["bytes"] / STEPS / 1e6,
    }
    print(f"[dryrun] {n_ranks} ranks on {device}: {STEPS} ShardedSession steps at {RES}x{RES} "
          f"grew {out['subdivided']} nodes ({out['nodes']} in all); every rank's frames "
          f"and pool equal")
    print(f"[dryrun] a step moves: pool bucket {out['bucket_words']} words; visit "
          f"all-reduce {out['visits_all_reduce_mb']:.4f} MB (int32, the pool's length); "
          f"largest step payload (patches) {out['largest_step_payload_kb']:.3f} KB; "
          f"candidate readback {out['candidate_readback_kb']:.3f} KB (rank 0, to the "
          f"host); frame all-gather {out['frame_all_gather_mb']:.4f} MB (image and "
          f"TraceResult)")
    return out
