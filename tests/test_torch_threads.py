"""The port's plain CPU paths give the same bits at any torch thread count.

The test suite runs torch on one intra-op thread a worker (the root
``conftest.py``), as the benchmark does; users of the CPU path run it at
many. Each case runs one computation at 1 thread and again at 4 and holds
every output bit-equal: a counted, shadowed u8 frame on a combined
warp+skip table whose rays take counted skip jumps, and the steps of a CPU
Session with the shipped ``Settings()``, without and with its combined
table.
"""

import numpy as np
import pytest
import torch

from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.app import session
from octree_tracer_tpu_torch.app.session import Session
from octree_tracer_tpu_torch.render import camera, skip, tracer

THREADS = (1, 4)


def at_threads(n: int, fn):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


def assert_bit_equal(a: torch.Tensor, b: torch.Tensor, what: str):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), what


# Rays past the intra-op grain (32,768 elements): at 4 threads every
# op over all the rays runs in several chunks.
RES = 256
LEVELS = 4
# Inside the root cube of a sparse random scene: the rays cross empty space
# on the combined table's skip cubes.
POS = np.array([-0.35, 0.55, -0.6], np.float32)
LOOK = np.array([0.3, -0.5, 1.0], np.float32)


@pytest.mark.parametrize("flags", [False, True], ids=["counts", "flags"])
def test_counted_frame_is_bit_equal_across_threads(flags, monkeypatch):
    words = state.u32_to_device(scenes.random_scene(6, 1500, 3), "cpu")
    table = skip.build_warp_skip_table(words, LEVELS)
    _, ci = camera.camera_matrices(POS, LOOK, 70.0, RES, RES)
    origin, dirs = camera.generate_rays_device(ci, RES, RES, "cpu")
    walks = []
    walk = tracer._jump_walk
    monkeypatch.setattr(tracer, "_jump_walk", lambda *a: walks.append(1) or walk(*a))

    def frame():
        return tracer.render_frame(words, origin, dirs, shadows=True, u8_image=True,
                                   warp_table=table, with_visits=True, visit_flags=flags)

    (img1, res1, vis1), (img4, res4, vis4) = (at_threads(n, frame) for n in THREADS)
    assert walks, "no counted skip jump taken"
    assert bool(res1.hit.any()) and bool((vis1 > 0).any())
    assert_bit_equal(img1, img4, "image")
    for name in res1._fields:
        assert_bit_equal(getattr(res1, name), getattr(res4, name), name)
    assert_bit_equal(vis1, vis4, "visits")


SESSION_RES = 256
SESSION_POS = np.array([0.25, 0.35, -2.3], np.float32)
SESSION_LOOK = np.array([-0.12, -0.17, 1.0], np.float32)


def session_steps(table: bool, steps: int = 10):
    """``steps`` steps of a CPU Session with the shipped ``Settings()`` on a
    small shell world, aimed as ``tests/test_torch_session.py`` aims one,
    with ``table`` its combined table from the first frame on: each step's
    frame, device pool and drained patches. The tree grows from its root,
    a level every other step under deferred feedback: ten steps drain some
    4,000 patches, three only 36."""
    s = Session(scenes.shell_world(6), SESSION_RES, SESSION_RES, pool_capacity=65536,
                device="cpu")
    s.character.pos, s.character.look = SESSION_POS.copy(), SESSION_LOOK.copy()
    s.settings.fov = 70.0
    if table:
        s.settings.warp_pool_words = 1
    drained = []
    drain = s.octree.drain_patches

    def logged():
        idx, vals = drain()
        drained.append((idx.copy(), vals.copy()))
        return idx, vals

    s.octree.drain_patches = logged
    out = []
    for _ in range(steps):
        img, _, _ = s.step()
        assert (s._warp_table is not None) == table
        out.append((img.clone(), s.device_words.clone(), list(drained)))
        drained.clear()
    return out


@pytest.mark.parametrize("table", [False, True], ids=["shipped", "combined_table"])
def test_session_steps_are_bit_equal_across_threads(table, monkeypatch):
    # The table at a level the CPU builds in a moment.
    monkeypatch.setattr(session, "WARP_LEVELS", 5)
    one, four = (at_threads(n, lambda: session_steps(table)) for n in THREADS)
    assert sum(idx.size for *_, d in one for idx, _ in d) > 0, "no patch drained"
    for i, ((img1, pool1, d1), (img4, pool4, d4)) in enumerate(zip(one, four)):
        assert_bit_equal(img1, img4, f"step {i} frame")
        assert_bit_equal(pool1, pool4, f"step {i} device_words")
        assert len(d1) == len(d4), f"step {i} drains"
        for (idx1, vals1), (idx4, vals4) in zip(d1, d4):
            np.testing.assert_array_equal(idx1, idx4, err_msg=f"step {i} patch slots")
            np.testing.assert_array_equal(vals1, vals4, err_msg=f"step {i} patch words")
