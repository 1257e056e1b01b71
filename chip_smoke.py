#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's six CUDA kernels from ``octree_tracer_tpu_torch/csrc``
(one ``nvcc`` per source, all started together), checks each against its
plain PyTorch version at the main paths' shapes, checks the traversal kernel
against the NumPy oracle on a subsample, and drives the two main paths:

- the frame: the bench's deep10 scene at 1920x1080 with shadows and the
  combined level-7 warp+skip table (phases 3-8);
- the adaptive streaming Session on the deep10 shell world at 1920x1080,
  with visit counting, candidate selection and the visit closure on the
  card (phases 9-11), and a CPU Session (plain versions) against a CUDA
  Session (kernels) in lockstep (phase 12).

    python3 chip_smoke.py        # from the repository root, one GPU

Every phase prints a line; any failure raises and exits non-zero. Without a
CUDA device it exits 1 and prints no result. The line before the last is a
JSON object with each kernel's launches on the Session path (and on the
frame path), its largest difference from the plain version and both times;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
DEPTH = 10
LEVELS = 7
# The bench's deep10 camera (bench.py:255-257).
CAM_POS = np.array([0.2, 0.3, -2.4], np.float32)
CAM_LOOK = np.array([-0.1, -0.15, 1.0], np.float32)
FOV = 70.0
ORACLE_RAYS = 16384
WARMUP, TIMED = 2, 5
SESSION_STEPS = 24
# Phase 12: a generic camera (from the default Character view knife-edge
# rays can flip between implementations), and a turn for collapses.
LOCK_RES, LOCK_DEPTH, LOCK_STEPS, LOCK_TURN = (128, 72), 8, 12, 8
LOCK_POS = np.array([0.25, 0.35, -2.3], np.float32)
LOCK_LOOK = np.array([-0.12, -0.17, 1.0], np.float32)
FRAME_KERNELS = ("trace", "warp_occupancy", "raygen", "shade_encode")

KERNELS = {
    "trace": ("octree_tracer_tpu_torch/csrc/trace.cu",
              "octree_tracer_tpu/render/tracer.py:135"),
    "warp_occupancy": ("octree_tracer_tpu_torch/csrc/warp_occupancy.cu",
                       "octree_tracer_tpu/render/tracer.py:2859"),
    "raygen": ("octree_tracer_tpu_torch/csrc/raygen.cu",
               "octree_tracer_tpu/render/camera.py:100"),
    "shade_encode": ("octree_tracer_tpu_torch/csrc/shade_encode.cu",
                     "octree_tracer_tpu/render/tracer.py:3132"),
    "select_candidates": ("octree_tracer_tpu_torch/csrc/select_candidates.cu",
                          "octree_tracer_tpu/adaptive/feedback.py:33"),
    "propagate_visits": ("octree_tracer_tpu_torch/csrc/propagate_visits.cu",
                         "octree_tracer_tpu/adaptive/feedback.py:96"),
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` on the device, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    return run(torch.device("cuda", 0))


def run(dev: torch.device) -> int:
    from octree_tracer_tpu_torch import kernels, scenes, state
    from octree_tracer_tpu_torch.render import camera, cpu_reference, skip, tracer

    report = {k: {"name": k, "route": "cuda", "source": s, "replaces": r}
              for k, (s, r) in KERNELS.items()}

    # 1. The card and the toolchain.
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    phase("1 env", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc} device {torch.cuda.get_device_name(0)}")

    # 2. Build the kernel library from the sources.
    t0 = time.perf_counter()
    path, log = kernels.build()
    kernels.library()
    phase("2 build", f"{time.perf_counter() - t0:.1f} s -> {path}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            phase("2 build", line.strip())

    # 3. The deep10 scene on the card.
    t0 = time.perf_counter()
    words_np = scenes.deep_shell(DEPTH)
    words = state.u32_to_device(words_np, dev)
    phase("3 scene", f"deep_shell({DEPTH}): {words_np.shape[0]} nodes, "
          f"{words_np.nbytes / 2**20:.1f} MiB pool, built in "
          f"{time.perf_counter() - t0:.1f} s")

    # 4. K2 against its plain version: exact.
    warp_k, occ_k = tracer.warp_occupancy(words, LEVELS)
    warp_p, occ_p = tracer.warp_occupancy_plain(words, LEVELS)
    check(torch.equal(warp_k, warp_p) and torch.equal(occ_k, occ_p),
          "warp_occupancy kernel differs from its plain version")
    report["warp_occupancy"].update(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: tracer.warp_occupancy(words, LEVELS), 20),
        plain_ms=cuda_ms(lambda: tracer.warp_occupancy_plain(words, LEVELS), 3),
    )
    t0 = time.perf_counter()
    table = skip.build_warp_skip_table(words, LEVELS)
    torch.cuda.synchronize()
    phase("4 K2", f"warp words and occupancy equal on {warp_k.numel()} cells; "
          f"{int(occ_k.sum())} occupied; kernel "
          f"{report['warp_occupancy']['ms']:.3f} ms, plain "
          f"{report['warp_occupancy']['plain_ms']:.3f} ms; combined table "
          f"{table.numel()} words in {time.perf_counter() - t0:.2f} s")

    # 5. K3 against its plain version on the bench camera.
    _, ci = camera.camera_matrices(CAM_POS, CAM_LOOK, FOV, W, H)
    ci_t = torch.from_numpy(ci).to(dev)
    origin, dirs = camera.generate_rays_device(ci, W, H, dev)
    origin_p, dirs_p = camera.generate_rays_device_plain(ci_t, W, H)
    err = max(float((dirs - dirs_p).abs().max()),
              float((origin - origin_p).abs().max()))
    check(err <= 2e-7, f"raygen kernel differs from plain by {err}")
    report["raygen"].update(
        max_abs_err=err,
        ms=cuda_ms(lambda: camera.generate_rays_device(ci, W, H, dev), 20),
        plain_ms=cuda_ms(lambda: camera.generate_rays_device_plain(ci_t, W, H), 5),
    )
    phase("5 K3", f"max |kernel - plain| {err:.3g} over {W}x{H} rays; kernel "
          f"{report['raygen']['ms']:.3f} ms, plain {report['raygen']['plain_ms']:.3f} ms")

    # 6. K1 against its plain version on the full primary wavefront, and
    #    against the NumPy oracle (no table) on a fixed subsample.
    n = W * H
    flat = dirs.reshape(n, 3)
    origins = origin.reshape(1, 3).expand(n, 3).contiguous()
    res_k = tracer.trace(words, origins, flat, warp_table=table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_p = tracer.trace_plain(words, origins, flat, warp_table=table)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    a_k, a_p = tracer.to_numpy(res_k), tracer.to_numpy(res_p)
    agree = tracer.agreement(a_k, a_p)
    hp_err = float(np.abs(a_k["hit_pos"] - a_p["hit_pos"])[agree].max())
    frac = float((~agree).mean())
    check(frac < 0.005, f"trace kernel disagrees with plain on {frac:.4%} of rays")
    check(hp_err <= 1e-5, f"trace hit_pos differs from plain by {hp_err}")
    report["trace"].update(
        max_abs_err=hp_err,
        ms=cuda_ms(lambda: tracer.trace(words, origins, flat, warp_table=table), 5),
        plain_ms=plain_s * 1e3,
    )
    sample = np.sort(np.random.default_rng(0).choice(n, ORACLE_RAYS, replace=False))
    res_0 = tracer.to_numpy(tracer.trace(words, origins, flat))
    res_o = cpu_reference.trace_rays(words_np, origin.cpu().numpy(),
                                     flat.cpu().numpy()[sample])
    agree_o = tracer.agreement({f: v[sample] for f, v in res_0.items()}, res_o)
    frac_o = float((~agree_o).mean())
    hp_o = float(np.abs(res_0["hit_pos"][sample] - res_o["hit_pos"])[agree_o].max())
    check(frac_o < 0.005, f"trace kernel disagrees with the oracle on {frac_o:.4%}")
    check(hp_o <= 1e-5, f"trace hit_pos differs from the oracle by {hp_o}")
    phase("6 K1", f"kernel vs plain (combined L{LEVELS}): {int((~agree).sum())} of "
          f"{n} rays disagree ({frac:.6f}), hit_pos max {hp_err:.3g}; kernel "
          f"(no table) vs oracle: {int((~agree_o).sum())} of {ORACLE_RAYS} "
          f"({frac_o:.6f}), hit_pos max {hp_o:.3g}; hits {int(a_k['hit'].sum())}; "
          f"kernel {report['trace']['ms']:.3f} ms, plain {plain_s * 1e3:.1f} ms")

    # 7. K4 against its plain version on the frame's own inputs.
    sh_o, sh_d, sh_a = tracer.shadow_rays(res_k)
    shadow_hit = tracer.trace(words, sh_o, sh_d, active_init=sh_a,
                              warp_table=table).hit
    img_k = tracer.shade(res_k, shadow_hit)
    img_p = tracer.shade_plain(res_k, shadow_hit)
    img_err = float((img_k - img_p).abs().max())
    u8_k = tracer.shade(res_k, shadow_hit, u8=True)
    u8_p = tracer.encode_u8_plain(img_p)
    u8_diff = (u8_k.int() - u8_p.int()).abs()
    u8_frac = float((u8_diff == 0).float().mean())
    check(img_err <= 1e-6, f"shade kernel differs from plain by {img_err}")
    check(u8_frac >= 0.999 and int(u8_diff.max()) <= 1,
          f"u8 encode: {u8_frac:.5f} equal, max diff {int(u8_diff.max())}")
    report["shade_encode"].update(
        max_abs_err=img_err,
        ms=cuda_ms(lambda: tracer.shade(res_k, shadow_hit, u8=True), 20),
        plain_ms=cuda_ms(lambda: tracer.encode_u8_plain(
            tracer.shade_plain(res_k, shadow_hit)), 5),
    )
    phase("7 K4", f"f32 max |kernel - plain| {img_err:.3g}; u8 equal on "
          f"{u8_frac:.6f} of channels, max diff {int(u8_diff.max())}; kernel "
          f"{report['shade_encode']['ms']:.3f} ms (u8), plain "
          f"{report['shade_encode']['plain_ms']:.3f} ms")

    # 8. The main path once, counted: table build, raygen, shadowed frame.
    kernels.reset_launches()
    table = skip.build_warp_skip_table(words, LEVELS)
    origin, dirs = camera.generate_rays_device(ci, W, H, dev)
    img, res, _ = tracer.render_frame(words, origin, dirs, shadows=True,
                                      warp_table=table, u8_image=True)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in FRAME_KERNELS}
    hits = int(res.hit.sum())
    check(all(v > 0 for v in launches.values()), f"a kernel never ran: {launches}")
    check(img.shape == (H, W, 3) and img.dtype == torch.uint8, "bad frame")
    check(0 < hits < n, f"implausible hit count {hits}")
    for k, v in launches.items():
        report[k]["frame_launches"] = v

    def frame(shadows):
        return tracer.render_frame(words, origin, dirs, shadows=shadows,
                                   warp_table=table, u8_image=True)

    ms_sh = cuda_ms(lambda: frame(True), TIMED, WARMUP)
    ms_pr = cuda_ms(lambda: frame(False), TIMED, WARMUP)
    power = nvidia_smi("clocks.sm,power.draw,power.limit")

    # The same frame through the plain versions on the card, once.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_p = tracer.trace_plain(words, origins, flat, warp_table=table)
    sh_o, sh_d, sh_a = tracer.shadow_rays(res_p)
    sh_p = tracer.trace_plain(words, sh_o, sh_d, active_init=sh_a, warp_table=table)
    img_p = tracer.encode_u8_plain(tracer.shade_plain(res_p, sh_p.hit))
    torch.cuda.synchronize()
    plain_frame_ms = (time.perf_counter() - t0) * 1e3
    px_equal = float(torch.all(img.reshape(n, 3) == img_p, dim=1).float().mean())
    check(px_equal >= 0.995, f"frame equals the plain frame on {px_equal:.5f}")
    phase("8 frame", f"{card}: deep{DEPTH} {W}x{H} shadows + combined L{LEVELS} "
          f"u8: {ms_sh:.3f} ms/frame, {(n + hits) / ms_sh / 1e3:.2f} Mrays/s "
          f"((W*H + hits)/t); primaries only {ms_pr:.3f} ms/frame, "
          f"{n / ms_pr / 1e3:.2f} Mrays/s; hits {hits}; launches {launches}; "
          f"plain frame {plain_frame_ms:.1f} ms; pixels equal to plain "
          f"{px_equal:.6f}; clocks.sm,power.draw,power.limit {power}")

    session_phases(dev, report, words, origins, flat, table, res_k, card)

    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def session_phases(dev, report, words, origins, flat, table, res_k, card) -> None:
    """Phases 9-12: visit marking, candidate selection and the visit closure
    against their plain versions, then the Session on the card."""
    from octree_tracer_tpu_torch import kernels, scenes, state
    from octree_tracer_tpu_torch.adaptive import feedback
    from octree_tracer_tpu_torch.app.session import Session
    from octree_tracer_tpu_torch.render import tracer

    n_words = words.shape[0]

    # 9. K1 with visits (counts and flags) against trace_plain, on the
    #    deep10 1080p primaries with the combined table; K4's show_hits view.
    marks = {}
    for mode, flags in (("counts", False), ("flags", True)):
        v_k = torch.zeros(n_words, dtype=torch.int32, device=dev)
        v_p = torch.zeros_like(v_k)
        r_k = tracer.trace(words, origins, flat, warp_table=table, visits=v_k,
                           visit_flags=flags)
        r_p = tracer.trace_plain(words, origins, flat, warp_table=table, visits=v_p,
                                 visit_flags=flags)
        check(torch.equal(r_k.index, r_p.index), f"trace {mode}: index differs")
        check(torch.equal(v_k, v_p), f"trace {mode}: visits differ from plain on "
              f"{int((v_k != v_p).sum())} slots")
        marks[mode] = v_k
    counts, flags = marks["counts"], marks["flags"]
    check(torch.equal(flags, (counts > 0).int()), "flags are not counts > 0")
    buf = torch.zeros(n_words, dtype=torch.int32, device=dev)
    t_plain = cuda_ms(lambda: tracer.trace(words, origins, flat, warp_table=table), TIMED)
    t_counts = cuda_ms(lambda: tracer.trace(words, origins, flat, warp_table=table,
                                            visits=buf), TIMED)
    t_flags = cuda_ms(lambda: tracer.trace(words, origins, flat, warp_table=table,
                                           visits=buf, visit_flags=True), TIMED)
    report["trace"].update(visits_exact=True, unmarked_ms=t_plain, counts_ms=t_counts,
                           flags_ms=t_flags)
    img_k = tracer.shade(res_k, hits_visits=counts)
    img_p = tracer.shade_plain(res_k, hits_visits=counts)
    hits_err = float((img_k - img_p).abs().max())
    check(hits_err <= 1e-6, f"show_hits view differs from plain by {hits_err}")
    report["shade_encode"].update(show_hits_err=hits_err)
    phase("9 K1 visits", f"counts and flags equal to plain on {n_words} slots "
          f"({int((counts > 0).sum())} marked, {int(counts.sum())} marks); K1 "
          f"unmarked {t_plain:.3f} ms, counts {t_counts:.3f} ms, flags "
          f"{t_flags:.3f} ms; K4 show_hits f32 max |kernel - plain| {hits_err:.3g}")

    # 10. K5 and K6 against their plain versions on phase 9's visits.
    for sub_cap, unsub_cap, offset in ((65536, 65536, 123457), (1024, 1024, 777)):
        args = (words, counts, n_words, sub_cap, unsub_cap, offset)
        out_k = feedback.select_candidates_packed(*args)
        out_p = feedback.select_candidates_plain(*args)
        err = int((out_k - out_p).abs().max())
        check(err == 0, f"select_candidates caps {sub_cap}: differs by {err}")
        over = int(out_k[0]) > sub_cap or int(out_k[1]) > unsub_cap
        ms_k = cuda_ms(lambda: feedback.select_candidates_packed(*args), 20)
        ms_p = cuda_ms(lambda: feedback.select_candidates_plain(*args), 5)
        if sub_cap == 65536:
            report["select_candidates"].update(max_abs_err=float(err), ms=ms_k,
                                               plain_ms=ms_p)
        phase("10 K5", f"caps {sub_cap}/{unsub_cap} offset {offset}: equal; sub_n "
              f"{int(out_k[0])}, unsub_n {int(out_k[1])}, overflow {over}; kernel "
              f"{ms_k:.3f} ms, plain {ms_p:.3f} ms")
    passes = DEPTH + 1
    closed_k = feedback.propagate_visits(words, flags, passes)
    closed_p = feedback.propagate_visits_plain(words, flags, passes)
    err = int((closed_k - closed_p).abs().max())
    check(err == 0, f"propagate_visits differs from plain by {err}")
    ms_k = cuda_ms(lambda: feedback.propagate_visits(words, flags, passes), 10)
    ms_p = cuda_ms(lambda: feedback.propagate_visits_plain(words, flags, passes), 3)
    report["propagate_visits"].update(max_abs_err=float(err), ms=ms_k, plain_ms=ms_p)
    phase("10 K6", f"{passes} passes equal to plain; {int((closed_k != flags).sum())} "
          f"interiors closed; kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms (all passes)")

    # 11. The Session on the card: deep10 shell world, 1080p, bench camera,
    #     shipped defaults (deferred feedback, flags, feedback every frame).
    t0 = time.perf_counter()
    world = scenes.shell_world(DEPTH)
    sess = Session(world, W, H, device=dev)
    sess.character.pos = CAM_POS.copy()
    sess.character.look = CAM_LOOK.copy()
    sess.settings.fov = FOV
    check(sess.use_native, "the native host engine did not build")
    setup_s = time.perf_counter() - t0
    kernels.reset_launches()
    step_ms, rode, warped_steps = [], 0, []
    totals = {"subdivided": 0, "collapsed": 0, "patched": 0}
    for i in range(SESSION_STEPS):
        t0 = time.perf_counter()
        img, _, stats = sess.step()
        img.cpu()  # the viewer's u8 frame fetch
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if sess._frame_warped:
            rode += 1
            warped_steps.append(i)
        for k in totals:
            totals[k] += stats[k]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for k, v in launches.items():
        report[k]["launches"] = v
    n_nodes, holes = sess.node_stats()
    pool = state.to_numpy_u32(sess.device_words)
    check(np.array_equal(pool[:n_nodes], sess.octree.nodes) and not pool[n_nodes:].any(),
          "the device pool differs from the host octree")
    check(rode > 0, f"no counted frame rode the table (bucket "
          f"{sess.device_words.shape[0]}, {n_nodes} nodes)")
    check(all(v > 0 for v in launches.values()),
          f"a kernel never ran on the Session path: {launches}")
    check(img.shape == (H, W, 3) and totals["subdivided"] > 0, "the Session did not grow")
    phase("11 session", f"{card}: deep{DEPTH} shell world {W}x{H}, setup "
          f"{setup_s:.1f} s, engine {'native' if sess.use_native else 'python'}; "
          f"{SESSION_STEPS} steps, median step {float(np.median(step_ms)):.1f} ms "
          f"(last 8: {float(np.median(step_ms[-8:])):.1f} ms, max {max(step_ms):.1f}); "
          f"bucket {sess.device_words.shape[0]}, nodes {n_nodes}, holes {holes:.2f}%, "
          f"max depth {sess.octree.max_depth}; totals {totals}; counted frames on "
          f"the table {rode} (steps {warped_steps}); stale dropped "
          f"{sess.stale_dropped}; launches {launches}; step ms "
          f"{[round(t, 1) for t in step_ms]}")

    # 12. A CPU Session (plain versions) and a CUDA Session (kernels) in
    #     lockstep; the table from the first frame, so K2 and K6 take part.
    base = state.world_to_numpy(scenes.shell_world(LOCK_DEPTH))
    pair = [Session(state.world_from_numpy(base), *LOCK_RES, device=d)
            for d in ("cpu", dev)]
    for s_ in pair:
        s_.character.pos = LOCK_POS.copy()
        s_.character.look = LOCK_LOOK.copy()
        s_.settings.fov = FOV
        s_.settings.warp_pool_words = 1
    lock_totals = {"subdivided": 0, "collapsed": 0, "patched": 0}
    for i in range(LOCK_STEPS):
        if i == LOCK_TURN:
            for s_ in pair:
                s_.character.turn(900.0, 300.0, fov=FOV)
        (img_c, _, st_c), (img_g, _, st_g) = (s_.step() for s_ in pair)
        check(torch.equal(img_c, img_g.cpu()), f"lockstep step {i}: images differ on "
              f"{int((img_c != img_g.cpu()).any(-1).sum())} pixels")
        check(st_c == st_g, f"lockstep step {i}: stats {st_c} vs {st_g}")
        check(torch.equal(pair[0].device_words, pair[1].device_words.cpu()),
              f"lockstep step {i}: pools differ")
        for k in lock_totals:
            lock_totals[k] += st_c[k]
    check(lock_totals["subdivided"] > 0 and lock_totals["collapsed"] > 0,
          f"the lockstep did not grow and collapse: {lock_totals}")
    phase("12 lockstep", f"CPU and CUDA Sessions equal at every step: shell "
          f"depth {LOCK_DEPTH}, {LOCK_RES[0]}x{LOCK_RES[1]}, {LOCK_STEPS} steps, "
          f"totals {lock_totals}, nodes {len(pair[1].octree)}, counted frames "
          f"on the table {pair[1]._frame_warped}")


if __name__ == "__main__":
    sys.exit(main())
