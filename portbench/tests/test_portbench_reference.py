"""The reference on tiny scenes: known hits by hand, the port's NumPy
oracle on a random tree, and the control (bfloat16) far from it."""

import numpy as np
import torch

from portbench.reference import camera, select, shell, trace

EMPTY = (1 << 27) << 4


def leaf(rgb):
    return ((1 << 27) + rgb) << 4


def test_one_voxel_by_hand():
    # A root group whose child 7 (+x, +y, +z) is a filled leaf.
    words = trace.widen(torch.tensor([EMPTY] * 7 + [leaf(0x804020)], dtype=torch.int64))
    origin = torch.tensor([0.5, 0.5, -3.0])
    dirs = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [-1e-3, 0.0, 1.0]])
    visits = torch.zeros(8, dtype=torch.int64)
    out = trace.trace_rays(words, origin, dirs, visits=visits)
    assert out["hit"].tolist() == [True, False, True]
    assert out["index"].tolist() == [7, -1, 7]
    # It enters the empty child 6 at z = -1, steps out of it onto the face
    # z = 0 and 2e-6 past it (the nudge), into the filled child 7; its
    # zero components are 1e-6, so x and y drift by 2e-6.
    assert torch.allclose(out["hit_pos"][0], torch.tensor([0.5, 0.5, 2e-6]), rtol=0, atol=1e-5)
    assert out["steps"][0] == 1
    assert torch.equal(out["normal"][0], torch.tensor([0.0, 0.0, -1.0]))
    assert visits.tolist() == [0, 0, 0, 0, 0, 0, 2, 2]  # child 6, then 7, twice
    # Shaded against the default sun the face towards -z is lit, and the
    # shadow ray (towards the sun, -z) leaves the cube.
    colour, shadow = trace.shade(words, out, visits=visits)
    assert not shadow.any()
    assert torch.equal(colour[1], torch.full((3,), 0.2) ** 2.2)


def test_shell_builder_layout():
    words = shell.shell_words(3)
    cells, _ = shell.shell_cells(3)
    payload = words >> 4
    assert (payload > (1 << 27)).sum() == cells.shape[0]
    assert words.shape[0] % 8 == 0


def test_matches_the_ports_oracle_on_a_random_tree():
    from octree_tracer_tpu_torch import scenes
    from octree_tracer_tpu_torch.render import cpu_reference

    w = scenes.random_scene(6, 3000, 3)
    ci = camera.camera_inverse([0.2, 0.3, -2.4], [-0.1, -0.15, 1.0], 70.0, 48, 32)
    origin, dirs = camera.primary_rays(ci, 48, 32, "cpu")
    ref = trace.render(trace.widen(torch.from_numpy(w.astype(np.int64))), origin, dirs,
                       with_visits=True)
    _, res, visits = cpu_reference.render_frame(w, origin.numpy(),
                                                dirs.numpy().reshape(32, 48, 3),
                                                with_visits=True)
    assert np.array_equal(ref["hit"].numpy(), res["hit"])
    assert np.array_equal(ref["index"].numpy(), res["index"])
    assert np.array_equal(ref["visits"].numpy(), visits)
    assert ref["hit"].float().mean() > 0.1


def test_control_in_bfloat16_differs():
    w = torch.from_numpy(shell.shell_words(6).astype(np.int64))
    ci = camera.camera_inverse([0.2, 0.3, -2.4], [-0.1, -0.15, 1.0], 70.0, 48, 32)
    origin, dirs = camera.primary_rays(ci, 48, 32, "cpu")
    f32 = trace.render(w, origin, dirs)
    bf16 = trace.render(w, origin, dirs, dtype=torch.bfloat16)
    differ = (f32["hit"] != bf16["hit"]) | (f32["index"] != bf16["index"])
    assert differ.float().mean() > 0.05


def test_candidates_rule():
    words = torch.tensor([8 << 4, leaf(1), leaf(0), 0, leaf(5), 16 << 4], dtype=torch.int64)
    visits = torch.tensor([0, 4, 9, 0, 3, 1])
    sub, unsub = select.candidates(words, visits, node_len=5)
    assert sub.tolist() == [False, True, False, False, False, False]
    assert unsub.tolist() == [True, False, False, False, False, False]
