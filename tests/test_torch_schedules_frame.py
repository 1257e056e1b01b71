"""The JAX package's own frame calls, run through the port as written, and
the named modes of ``render_frame``, against JAX on the CPU (the port's
plain versions of kernels K1, K3, K4 and K11).

JAX's calls, at 64x64 on a scene built here (the bench's depth-10 shell
cut to depth 6; its combined table at level 4, not 7):

- ``bench.py:66-77``, ``frame`` and ``frame_shadows``: beam mode,
  ``raw_result``, u8, the combined table;
- ``bench.py:96-101``, the burst's frame: rays from
  ``generate_rays_device(ci, W, H, block_major=8)``, beam mode,
  ``pre_permuted``, ``raw_result``, u8, the combined table;
- ``app/cli.py:128-130``, the CLI's ``bench``: staged mode;
- ``app/session.py:387-406``, the Session's frame with its defaults: beam
  mode, counted visits as flags, ``raw_result``, u8, ``pre_permuted``;
- ``__graft_entry__.py:36-38``: beam mode, the f32 image.

The rules, the repository's (``tests/test_tracer.py:1-11``,
``test_torch_render.py``):

- hit, forced, index, word, normal, steps and depth equal but on
  knife-edge rays, under 0.5% of the frame; ``hit_pos`` within 1e-5 on the
  others. JAX's beam frame under a combined table counts ``steps``
  otherwise than its own ``trace`` and staged frame (its lockstep stage
  steps cell by cell where they skip: on the bench frame 1,422 of 4,096
  rays, 250 of them hits, and ``depth`` on 125 misses), so there those two
  fields are left out; the port's equal its ``trace``'s, which
  ``test_torch_render.py`` and ``test_torch_trace.py`` hold against JAX's
  ``trace``;
- the u8 image equal on at least 99.5% of pixels, the f32 image within
  1e-6 (XLA's CPU ``pow`` rounds otherwise than PyTorch's by an ulp);
- visits: filled-leaf counts and the interior zero-set exact; with
  ``beams`` in the tiled mode, where JAX's frame is ``trace`` plus the
  same beam marks, every count.

A raw result is in the block order on both sides; it is compared as it
comes, and the port's is also held to its own pixel-order frame after
``_block_to_pixel`` exactly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu.render import camera as jcam
from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu.render import tracer as jtracer
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET
from octree_tracer_tpu_torch.render import camera as tcam
from octree_tracer_tpu_torch.render import skip as tskip
from octree_tracer_tpu_torch.render import tracer as ttracer

LEVELS = 4
# bench.py:57-58, the bench camera.
POS = np.array([0.4, 0.6, -2.2], np.float32)
LOOK = np.array([-0.2, -0.35, 1.0], np.float32)
HIT_FIELDS = ("hit", "forced", "index", "word")


@functools.lru_cache(maxsize=None)
def _scene(depth=6):
    words = scenes.deep_shell(depth)
    return words, np.asarray(jskip.build_warp_skip_table(jnp.asarray(words), LEVELS))


@functools.lru_cache(maxsize=None)
def _camera(res, pos=tuple(POS), look=tuple(LOOK)):
    _, ci = jcam.camera_matrices(np.array(pos, np.float32), np.array(look, np.float32), 70.0,
                                 res, res)
    o, d = jcam.generate_rays(ci, res, res)
    return ci, np.asarray(o), np.asarray(d)


def _port_inputs(words, table):
    return (state.u32_to_device(words, "cpu"),
            None if table is None else state.table_to_device(table, "cpu"))


def _jax_inputs(words, table):
    return jnp.asarray(words), None if table is None else jnp.asarray(table)


def _agree(a, b, steps=True):
    """Rays whose fields agree (``steps`` and ``depth`` too under
    ``steps``)."""
    agree = np.all(a["normal"] == b["normal"], axis=-1)
    for f in HIT_FIELDS + (("steps", "depth") if steps else ()):
        agree &= a[f] == b[f]
    return agree


def _check_result(res, res_j, beam_table=False):
    """``beam_table``: JAX's beam frame under a combined table, whose steps
    and depth are its lockstep stage's."""
    a, b = ttracer.to_numpy(res), ttracer.to_numpy(res_j)
    agree = _agree(a, b, steps=not beam_table)
    assert (~agree).mean() < 0.005, f"{int((~agree).sum())} rays differ"
    assert np.abs(a["hit_pos"] - b["hit_pos"])[agree].max() <= 1e-5
    assert a["hit"].sum() > 0
    return agree


def _check_u8(img, img_j):
    assert img.dtype == torch.uint8
    equal = np.all(img.numpy() == np.asarray(img_j), axis=-1)
    assert equal.mean() >= 0.995, f"{int((~equal).sum())} pixels differ"


def _check_visits(words, v, vj, exact=False):
    v, vj = v.numpy(), np.asarray(vj)
    if exact:
        np.testing.assert_array_equal(v, vj)
    payload = words >> np.uint32(4)
    filled, interior = payload > VOXEL_OFFSET, (payload < VOXEL_OFFSET) & (words != 0)
    np.testing.assert_array_equal(v[filled], vj[filled])
    np.testing.assert_array_equal(v[interior] == 0, vj[interior] == 0)
    assert v[filled].sum() > 0 and (v[interior] > 0).any()


def _pixel_frame(words, origin, dirs, **kw):
    """The port's own frame (mode None) in pixel order."""
    return ttracer.render_frame(words, origin, dirs, **kw)


def _same_as_pixel_frame(img, res, visits, ref, order=None):
    """A named mode's outputs against the port's pixel-order frame, exactly:
    the schedule changes no output of the port's but the result's order."""
    img0, res0, visits0 = ref
    assert torch.equal(img, img0)
    if order is not None:
        res = ttracer.TraceResult(*(ttracer._block_to_pixel(f, *order) for f in res))
    assert all(torch.equal(x, y) for x, y in zip(res, res0))
    assert (visits is None) == (visits0 is None)


# -- JAX's own calls -------------------------------------------------------


@pytest.mark.parametrize("shadows", [False, True], ids=["frame", "frame_shadows"])
def test_bench_frame_call(shadows):
    """bench.py:66-77."""
    W = H = 64
    words, mskip = _scene()
    _, origin, dirs = _camera(W)
    wj, mj = _jax_inputs(words, mskip)
    oj, dj = jnp.asarray(origin), jnp.asarray(dirs)
    img_j, res_j, _ = jtracer.render_frame(
        wj, oj, dj, jnp.asarray(jtracer.DEFAULT_SUN), shadows=shadows, mode="beam",
        raw_result=True, u8_image=True, warp_table=mj)

    tracer = ttracer
    words, mskip = _port_inputs(words, mskip)
    oj, dj = torch.from_numpy(origin), torch.from_numpy(dirs)
    sun = torch.as_tensor(tracer.DEFAULT_SUN)
    img, res, _ = tracer.render_frame(
        words, oj, dj, sun, shadows=shadows, mode="beam", raw_result=True,
        u8_image=True, warp_table=mskip,
    )
    _check_u8(img, img_j)
    _check_result(res, res_j, beam_table=True)
    assert abs(int(res.hit.sum()) - int(res_j.hit.sum())) <= 0.005 * W * H
    ref = _pixel_frame(words, oj, dj, shadows=shadows, warp_table=mskip, u8_image=True)
    _same_as_pixel_frame(img, res, None, ref, order=(H, W, 8, False))


def test_bench_burst_call():
    """bench.py:96-101 with ``shadows=True``: rays generated in the block
    order (the port's raygen takes its device as the fourth argument)."""
    W = H = 64
    words, mskip = _scene()
    ci, origin, dirs = _camera(W)
    wj, mj = _jax_inputs(words, mskip)
    o1, d1 = jcam.generate_rays_device(ci, W, H, block_major=8)
    img_j, res_j, _ = jtracer.render_frame(
        wj, o1, d1.reshape(H, W, 3), jnp.asarray(jtracer.DEFAULT_SUN), shadows=True,
        mode="beam", raw_result=True, u8_image=True,
        pre_permuted=True, warp_table=mj,
    )

    tracer = ttracer
    words, mskip = _port_inputs(words, mskip)
    sun = torch.as_tensor(tracer.DEFAULT_SUN)
    o1, d1 = tcam.generate_rays_device(ci, W, H, "cpu", block_major=8)
    img, res, _ = tracer.render_frame(
        words, o1, d1.reshape(H, W, 3), sun, shadows=True,
        mode="beam", raw_result=True, u8_image=True,
        pre_permuted=True, warp_table=mskip,
    )
    _check_u8(img, img_j)
    _check_result(res, res_j, beam_table=True)
    o_p, d_p = tcam.generate_rays_device(ci, W, H, "cpu")
    ref = _pixel_frame(words, o_p, d_p, warp_table=mskip, u8_image=True)
    _same_as_pixel_frame(img, res, None, ref, order=(H, W, 8, False))


def test_cli_bench_call():
    """app/cli.py:128-130 (shadows on, the command's default)."""
    W = H = 64
    words_np, _ = _scene()
    _, origin, dirs = _camera(W)
    img_j, res_j, _ = jtracer.render_frame(
        jnp.asarray(words_np), jnp.asarray(origin), jnp.asarray(dirs),
        jnp.asarray(jtracer.DEFAULT_SUN), shadows=True, mode="staged")
    words, _ = _port_inputs(words_np, None)
    oj, dj = torch.from_numpy(origin), torch.from_numpy(dirs)
    sun = torch.as_tensor(ttracer.DEFAULT_SUN)
    img, res, _ = ttracer.render_frame(
        words, oj, dj, sun, shadows=True, mode="staged",
    )
    agree = _check_result(res, res_j)
    np.testing.assert_allclose(img.numpy().reshape(-1, 3)[agree],
                               np.asarray(img_j).reshape(-1, 3)[agree], rtol=1e-6, atol=1e-7)
    _same_as_pixel_frame(img, res, None, _pixel_frame(words, oj, dj))


def test_session_frame_call():
    """app/session.py:387-406 with the Session's defaults (shadows, counted
    visits as flags, no table under its pool-size gate) in beam mode, the
    rays from the block-order raygen, as ``Session._render_frame`` makes
    them (session.py:369-376)."""
    W = H = 64
    words_np, _ = _scene()
    ci, _, _ = _camera(W)
    adaptive, visit_flags, show_hits = True, True, False
    mode = "beam" if H % 8 == 0 and W % 8 == 0 else "staged"
    o_j, d_j = jcam.generate_rays_device(ci, W, H, block_major=8 if mode == "beam" else 0)
    img_j, res_j, visits_j = jtracer.render_frame(
        jnp.asarray(words_np), jnp.asarray(o_j), jnp.asarray(d_j.reshape(H, W, 3)),
        jnp.asarray(jtracer.DEFAULT_SUN), shadows=True, show_steps=False,
        show_hits=show_hits, with_visits=adaptive, misc_bool=False, mode=mode,
        raw_result=True, u8_image=True, pre_permuted=mode == "beam", warp_table=None,
        visit_flags=adaptive and visit_flags and not show_hits)

    words, _ = _port_inputs(words_np, None)
    origin, dirs = tcam.generate_rays_device(ci, W, H, "cpu",
                                             block_major=8 if mode == "beam" else 0)
    img, result, visits = ttracer.render_frame(
        words,
        origin,
        dirs.reshape(H, W, 3),
        torch.as_tensor(ttracer.DEFAULT_SUN),
        shadows=True,
        show_steps=False,
        show_hits=show_hits,
        with_visits=adaptive,
        misc_bool=False,
        mode=mode,
        raw_result=True,
        u8_image=True,
        pre_permuted=mode == "beam",
        warp_table=None,
        visit_flags=adaptive and visit_flags and not show_hits,
    )
    _check_u8(img, img_j)
    _check_result(result, res_j)
    _check_visits(words_np, visits, visits_j)
    o_p, d_p = tcam.generate_rays_device(ci, W, H, "cpu")
    ref = _pixel_frame(words, o_p, d_p, u8_image=True, with_visits=True, visit_flags=True)
    _same_as_pixel_frame(img, result, visits, ref, order=(H, W, 8, False))
    assert torch.equal(visits, ref[2])


def test_graft_entry_call():
    """__graft_entry__.py:36-38: the flagship's f32 image."""
    W = H = 64
    words_np, _ = _scene()
    _, origin, dirs = _camera(W)
    img_j, res_j, _ = jtracer.render_frame(
        jnp.asarray(words_np), jnp.asarray(origin), jnp.asarray(dirs),
        jnp.asarray(jtracer.DEFAULT_SUN), shadows=True, mode="beam")
    words, _ = _port_inputs(words_np, None)
    img, res, _ = ttracer.render_frame(
        words, torch.from_numpy(origin), torch.from_numpy(dirs),
        torch.as_tensor(ttracer.DEFAULT_SUN), shadows=True, mode="beam")
    agree = _check_result(res, res_j)
    np.testing.assert_allclose(img.numpy().reshape(-1, 3)[agree],
                               np.asarray(img_j).reshape(-1, 3)[agree], rtol=1e-6, atol=1e-7)


def test_beam_table_show_steps_departs_from_jax_by_steps_only():
    """A departure from the reference, shown and bounded: JAX's beam frame
    under a combined table reports its lockstep stage's ``steps`` (on this
    frame 1,422 of 4,096 rays, by -1 to +3, and ``depth`` on 125 misses),
    which the port does not reproduce: its beam frame reports ``trace``'s.
    With ``show_steps`` (grey = min(steps, 64) / 64) the port's beam frame
    equals JAX's staged frame with the same table (whose ``steps`` are
    ``trace``'s) by the u8 rule; against JAX's beam frame its pixels differ
    only where ``steps`` differ, on under 40% of the frame, by at most 12
    levels (3 steps: 3 / 64 of 255, rounded up)."""
    W = H = 64
    words, mskip = _scene()
    _, origin, dirs = _camera(W)
    wj, mj = _jax_inputs(words, mskip)
    kw = dict(shadows=True, show_steps=True, u8_image=True)
    sun = jnp.asarray(jtracer.DEFAULT_SUN)
    img_b, res_b, _ = jtracer.render_frame(wj, jnp.asarray(origin), jnp.asarray(dirs), sun,
                                           mode="beam", warp_table=mj, **kw)
    img_s, _, _ = jtracer.render_frame(wj, jnp.asarray(origin), jnp.asarray(dirs), sun,
                                       mode="staged", warp_table=mj, warp_in_body=True, **kw)
    words, mskip = _port_inputs(words, mskip)
    img, res, _ = ttracer.render_frame(words, torch.from_numpy(origin),
                                       torch.from_numpy(dirs), mode="beam", warp_table=mskip,
                                       **kw)
    _check_u8(img, img_s)
    steps, steps_j = res.steps.numpy(), np.asarray(res_b.steps)
    moved = (steps != steps_j).reshape(H, W)
    differ = np.any(img.numpy() != np.asarray(img_b), axis=-1)
    assert not (differ & ~moved).any()
    assert 0 < differ.sum() < 0.4 * W * H
    assert np.abs(steps_j - steps).max() <= 3
    assert np.abs(img.numpy().astype(int) - np.asarray(img_b).astype(int)).max() <= 12


# -- the named modes ---------------------------------------------------------

RES = 32
# Inside the root cube: every ray starts at the camera, so a tile's corner
# entry points are the camera's, not points on the cube's face, which JAX's
# compiled ``beam_start`` rounds otherwise than its own eager expressions
# (XLA contracts ``origin + d * dist`` on the CPU), moving some rays' starts
# and so the root group's counts.
INSIDE = ((-0.35, 0.55, -0.6), (0.3, -0.5, 1.0))
# (mode, beams, raw_result, pre_permuted, visits, beam_iters): every mode
# with and without beams, raw results on and off (and Morton tiles), counts
# and flags; ``pre_permuted`` is the burst's and the Session's call above.
MODES = {
    "tiled": ("tiled", None, False, False, "counts", 16),
    "tiled beams8": ("tiled", 8, False, False, "counts", 16),
    "staged": ("staged", None, False, False, "counts", 16),
    "staged beams8 flags": ("staged", 8, False, False, "flags", 16),
    "beam": ("beam", None, False, False, "counts", 16),
    "beam morton raw": ("beam", 8, True, False, "counts", (16, 8)),
}


@pytest.mark.parametrize("case", list(MODES))
def test_render_frame_mode_equals_jax(case):
    mode, beams, raw, pre, visits_kind, beam_iters = MODES[case]
    order = (RES, RES, beams or 8, beam_iters != 16)
    words_np = scenes.random_scene(6, 1500, 3)
    _, origin, dirs = _camera(RES, *INSIDE)
    flags = visits_kind == "flags"
    kw = dict(shadows=True, with_visits=True, visit_flags=flags, mode=mode, beams=beams,
              raw_result=raw, pre_permuted=pre, beam_iters=beam_iters)
    img_j, res_j, visits_j = jtracer.render_frame(
        jnp.asarray(words_np), jnp.asarray(origin), jnp.asarray(dirs),
        jnp.asarray(jtracer.DEFAULT_SUN), **kw)
    words, _ = _port_inputs(words_np, None)
    o, d = torch.from_numpy(origin), torch.from_numpy(dirs)
    img, res, visits = ttracer.render_frame(words, o, d, **kw)
    agree = _check_result(res, res_j)
    if raw:  # the image is in pixel order, the result in the block order
        agree = ttracer._block_to_pixel(torch.from_numpy(agree), *order).numpy()
    np.testing.assert_allclose(img.numpy().reshape(-1, 3)[agree],
                               np.asarray(img_j).reshape(-1, 3)[agree], rtol=1e-6, atol=1e-7)
    _check_visits(words_np, visits, visits_j, exact=mode == "tiled")
    ref = _pixel_frame(words, o, d, with_visits=True, visit_flags=flags)
    _same_as_pixel_frame(img, res, visits, ref, order if raw else None)
    if beams and mode != "beam":
        # Rays start below the root, and the tiles' marks keep the
        # invariants of the frame without them.
        assert int((ttracer.beam_start(words, o, d, beams)[0][2] > 0).sum()) > 0
        assert not torch.equal(visits, ref[2])
        _check_visits(words_np, visits, ref[2].numpy())
    else:
        assert torch.equal(visits, ref[2])


def test_warp_in_body_false_equals_jax():
    """``warp_in_body=False`` in the staged mode: the combined table seeds
    each ray's first descent only, so no step skips (``steps`` are the
    no-table frame's) and restarts go to the parent or the root."""
    words_np, table = _scene(5)
    _, origin, dirs = _camera(RES)
    img_j, res_j, _ = jtracer.render_frame(
        jnp.asarray(words_np), jnp.asarray(origin), jnp.asarray(dirs),
        jnp.asarray(jtracer.DEFAULT_SUN), mode="staged", warp_table=jnp.asarray(table),
        warp_in_body=False, u8_image=True)
    words, tab = _port_inputs(words_np, table)
    o, d = torch.from_numpy(origin), torch.from_numpy(dirs)
    img, res, _ = ttracer.render_frame(words, o, d, mode="staged", warp_table=tab,
                                       warp_in_body=False, u8_image=True)
    _check_u8(img, img_j)
    _check_result(res, res_j)
    plain = ttracer.render_frame(words, o, d, u8_image=True)[1]
    assert torch.equal(res.steps, plain.steps) and torch.equal(res.hit_pos, plain.hit_pos)
    skipping = ttracer.render_frame(words, o, d, u8_image=True, warp_table=tab)[1]
    assert not torch.equal(res.steps, skipping.steps)
