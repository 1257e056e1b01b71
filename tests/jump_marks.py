"""What the port's parity tests hold against JAX on counted passes that ride
a combined warp+skip table.

The port repairs JAX's skip jump (ROADMAP §2): a counted jump also marks
the empty leaf that covers each table cell it crosses (``tracer._jump_slots``),
which JAX's jump leaves unread, so after the visit closure the counted frame
leaves the interior zero-set of a root descent, and the Session's collapse
decisions are the reference's. Hits, images and every mark of a slot that
is not an empty leaf stay JAX's; on empty leaves the port's marks are JAX's
and the jumps'. A counted jump also counts the boundary steps that a root
descent takes across it (the same walk), where JAX's counts one,
so the counted ``steps`` are JAX's on the same table with its skip half
zeroed (``skip_free``), which takes every one of those steps. Where the pool
is well formed, the closed zero-set and the filled-leaf counts are held
against the plain reference's root descent (``portbench/reference/trace.py``).
"""

import sys
from pathlib import Path

import numpy as np
import torch

from octree_tracer_tpu_torch import state
from octree_tracer_tpu_torch.adaptive import feedback
from octree_tracer_tpu_torch.core.voxel import VOXEL_OFFSET

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import trace as ref_trace  # noqa: E402


def kinds(words: np.ndarray):
    """(filled leaf, empty leaf, interior) masks of u32 ``words``."""
    payload = words >> np.uint32(4)
    return (payload > VOXEL_OFFSET, payload == VOXEL_OFFSET,
            (payload < VOXEL_OFFSET) & (words != 0))


def skip_free(table) -> np.ndarray:
    """A copy of the combined warp+skip ``table`` with its skip half zeroed:
    a trace that rides it takes no jump, so its ``steps`` are the ones a
    counted trace on ``table`` reports."""
    out = np.array(table, copy=True)
    out[1::2] = 0
    return out


def assert_jax_marks_with_jumps(words, v, vj, exact: bool = True) -> None:
    """The port's marks ``v`` against JAX's ``vj``: equal on every slot
    that is not an empty leaf (``exact=False``: the same slots marked
    there), and on empty leaves at least JAX's."""
    _, empty, _ = kinds(words)
    v, vj = np.asarray(v), np.asarray(vj)
    if exact:
        np.testing.assert_array_equal(v[~empty], vj[~empty])
    else:
        np.testing.assert_array_equal(v[~empty] > 0, vj[~empty] > 0)
    assert (v[empty] >= vj[empty]).all()


def reference_visits(words, origins, dirs, shadows: bool | None = None) -> np.ndarray:
    """The reference's visits (int64) of rays ``dirs`` f32[N, 3] from
    ``origins`` (f32[3] or f32[N, 3]) through u32 ``words``: its frame
    (primaries and every hit's shadow ray) when ``shadows`` is given, else
    the rays alone."""
    w = ref_trace.widen(torch.from_numpy(np.asarray(words).view(np.int32)))
    o = torch.from_numpy(np.ascontiguousarray(origins, np.float32))
    d = torch.from_numpy(np.ascontiguousarray(dirs, np.float32).reshape(-1, 3))
    if shadows is not None:
        return ref_trace.render(w, o, d, shadows=shadows, with_visits=True)["visits"].numpy()
    visits = torch.zeros(w.shape[0], dtype=torch.int64)
    ref_trace.trace_rays(w, o, d, visits=visits)
    return visits.numpy()


def assert_reference_zero_set(words, v, ref, passes: int = 12,
                              filled_counts: bool = True) -> None:
    """The closure of the port's marks ``v`` leaves the reference's
    interior zero-set, and (``filled_counts``) its filled-leaf counts are
    the reference's ``ref``."""
    filled, _, interior = kinds(words)
    closed = feedback.propagate_visits(state.u32_to_device(words, "cpu"),
                                       torch.as_tensor(np.asarray(v, np.int32)),
                                       passes).numpy()
    np.testing.assert_array_equal(closed[interior] == 0, ref[interior] == 0)
    if filled_counts:
        np.testing.assert_array_equal(np.asarray(v)[filled], ref[filled])
