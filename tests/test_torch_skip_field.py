"""The skip field: ``build_skip_field`` on CPU tensors (the NumPy build,
``build_skip_field_plain``) equals the JAX package's at levels 0-7; a NumPy
transcription of kernel K12's own algorithm (``csrc/skip_field.cu``: bit
words along z, 32x32 tiles in 64x64 regions, fourteen in-place cube steps,
the count as four bit planes, one byte a (sx, sy) block) equals the plain
build on random, empty, full and single-cell grids at levels 0-6;
``k12_bytes``; the levels check; and a CPU Session's in-place rebuild of its
table's skip half."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu.render import skip as jskip
from octree_tracer_tpu_torch import scenes, state
from octree_tracer_tpu_torch.app import session
from octree_tracer_tpu_torch.app.session import Session
from octree_tracer_tpu_torch.render import skip

# K12's constants (csrc/skip_field.cu).
TILE, REGION = 32, 64
OFFSETS = (1,) * 11 + (4, 8, 8)
ONES = np.uint32(0xFFFFFFFF)


def _fshr(lo, hi, o):
    """CUDA's __funnelshift_r: the low word of hi:lo >> o."""
    return (lo >> np.uint32(o)) | (hi << np.uint32(32 - o))


def _fshl(lo, hi, o):
    """CUDA's __funnelshift_l: the high word of hi:lo << o."""
    return (hi << np.uint32(o)) | (lo >> np.uint32(32 - o))


def _empty_words(occ3: np.ndarray) -> np.ndarray:
    """uint32[side, side, nz]: bit j of word q set where cell z = 32q + j is
    empty; bits at z >= side set."""
    side = occ3.shape[0]
    nz = max(1, side // 32)
    pad = np.ones((side, side, 32 * nz), dtype=bool)
    pad[:, :, :side] = ~occ3
    bits = pad.reshape(side, side, nz, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(axis=-1).astype(np.uint32)


def _shift_ahead(a: np.ndarray, o: int, axis: int) -> np.ndarray:
    """a's value o columns ahead along ``axis`` of the region; past the
    region, all empty."""
    out = np.full_like(a, ONES)
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    src[axis], dst[axis] = slice(o, None), slice(None, a.shape[axis] - o)
    out[tuple(dst)] = a[tuple(src)]
    return out


def k12_transcription(occ: np.ndarray, levels: int) -> np.ndarray:
    """K12's algorithm in NumPy, block by block: uint32[8^levels] skip
    words from occupancy bool[8^levels]."""
    side = 1 << levels
    nz = max(1, side // 32)
    ntile = -(-side // TILE)
    empty = _empty_words(occ.reshape(side, side, side))
    out = np.zeros(side ** 3, dtype=np.uint32)
    r = np.arange(REGION)
    for bx in range(ntile * ntile):
        x0, y0 = (bx // ntile) * TILE, (bx % ntile) * TILE
        for quad in range(4):
            sx, sy = quad >> 1, quad & 1
            # Region (rx, ry) -> absolute (x, y), in the octant's direction.
            xs = x0 + r if sx else x0 + TILE - 1 - r
            ys = y0 + r if sy else y0 + TILE - 1 - r
            inside = ((xs >= 0) & (xs < side))[:, None] & ((ys >= 0) & (ys < side))[None, :]
            cx, cy = np.clip(xs, 0, side - 1), np.clip(ys, 0, side - 1)
            for q in range(nz):
                def word(qq):
                    if not 0 <= qq < nz:
                        return np.full((REGION, REGION), ONES)
                    return np.where(inside, empty[cx[:, None], cy[None, :], qq], ONES)
                p0, p1, m0, m1 = word(q), word(q + 1), word(q), word(q - 1)
                acc = np.zeros((8, REGION, REGION), dtype=np.uint32)
                acc[0], acc[4] = m0, p0  # codebook index 1
                for s, o in enumerate(OFFSETS):
                    p0 = p0 & _fshr(p0, p1, o)
                    p1 = p1 & _fshr(p1, ONES, o)
                    m0 = m0 & _fshl(m1, m0, o)
                    m1 = m1 & _fshl(ONES, m1, o)
                    for axis in (1, 0):  # y, then x
                        p0, p1, m0, m1 = (v & _shift_ahead(v, o, axis)
                                          for v in (p0, p1, m0, m1))
                    i = s + 2
                    for b in range(4):
                        if i % (1 << b) == 0:
                            acc[b] ^= m0
                            acc[4 + b] ^= p0
                # Byte sx*2 + sy of each output cell: the 8 planes' bits.
                j = np.arange(32, dtype=np.uint32)
                planes = acc[:, :TILE, :TILE, None]
                byte = ((planes >> j) & 1) << np.arange(8, dtype=np.uint32)[:, None, None, None]
                byte = byte.sum(axis=0, dtype=np.uint32)  # [rx, ry, j]
                z = q * 32 + j
                ox, oy = xs[:TILE], ys[:TILE]
                keep = ((ox < side)[:, None, None] & (oy < side)[None, :, None]
                        & (z < side)[None, None, :])
                cell = (ox[:, None, None] * side + oy[None, :, None]) * side + z[None, None, :]
                out[cell[keep]] |= byte[keep] << np.uint32(8 * (sx * 2 + sy))
    return out


def _grids(kind: str, levels: int, seed: int = 5) -> list[np.ndarray]:
    """Occupancy grids bool[side, side, side] of one kind."""
    side = 1 << levels
    rng = np.random.default_rng(seed + 10 * levels)
    if kind.startswith("density"):
        return [rng.random((side,) * 3) < float(kind.split("-")[1])]
    if kind == "empty":
        return [np.zeros((side,) * 3, dtype=bool)]
    if kind == "full":
        return [np.ones((side,) * 3, dtype=bool)]
    hi = side - 1
    if kind == "corners":
        cells = [(x, y, z) for x in (0, hi) for y in (0, hi) for z in (0, hi)]
    else:  # one cell on each face, off its centre
        a, b = side // 3, (2 * side) // 3
        cells = [(0, a, b), (hi, b, a), (a, 0, b), (b, hi, a), (a, b, 0), (b, a, hi)]
    grids = []
    for c in cells:
        g = np.zeros((side,) * 3, dtype=bool)
        g[c] = True
        grids.append(g)
    return grids


KINDS = ["density-0.001", "density-0.02", "density-0.2", "density-0.6", "empty", "full",
         "corners", "faces"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("levels", range(7))
def test_k12_transcription_equals_plain(levels, kind):
    for grid in _grids(kind, levels):
        occ = torch.from_numpy(grid.reshape(-1).copy())
        expect = state.to_numpy_u32(skip.build_skip_field_plain(occ, levels))
        np.testing.assert_array_equal(k12_transcription(grid.reshape(-1), levels), expect)


@pytest.mark.parametrize("levels", range(8))
def test_cpu_build_equals_jax(levels):
    words = scenes.deep_shell(7)
    expect = np.asarray(jskip.build_skip_field(jnp.asarray(words), levels))
    got = skip.build_skip_field(state.u32_to_device(words, "cpu"), levels)
    np.testing.assert_array_equal(state.to_numpy_u32(got), expect)
    # The occupancy passed in, and into a combined table's odd words.
    occ = skip.occupancy_from_pool(state.u32_to_device(words, "cpu"), levels)
    table = torch.full((2 << (3 * levels),), 7, dtype=torch.int32)
    assert skip.build_skip_field(torch.zeros(1, dtype=torch.int32), levels, occ=occ,
                                 table=table) is table
    np.testing.assert_array_equal(state.to_numpy_u32(table[1::2]), expect)
    assert (table[0::2] == 7).all()


def test_k12_bytes():
    assert skip.k12_bytes(7) == 10_485_760
    assert [skip.k12_bytes(lv) for lv in range(10)] == [5 * 8 ** lv for lv in range(10)]


@pytest.mark.parametrize("levels", [-1, 10])
def test_levels_outside_range_raise(levels):
    words = state.u32_to_device(scenes.deep_shell(4), "cpu")
    with pytest.raises(ValueError, match="levels"):
        skip.build_skip_field(words, levels)


def test_session_rebuild_writes_only_the_skip_half(monkeypatch):
    """After small collapse batches zero the skip half and leave the table,
    the Session's rebuild rewrites its table's odd words, equal to a fresh
    combined table's, and leaves the warp words as they were."""
    monkeypatch.setattr(session, "WARP_LEVELS", 5)
    s = Session(scenes.shell_world(7), 32, 32, pool_capacity=1 << 18, device="cpu")
    s.character.pos = np.array([0.25, 0.35, -1.3], np.float32)
    s.character.look = np.array([-0.12, -0.17, 1.0], np.float32)
    s.settings.warp_pool_words = 1
    rebuilt = 0
    for i in range(18):
        if i >= 10:
            s.character.turn(60.0, 0.0, fov=90.0)
        if s._skip_stale and not s._warp_dirty:
            before = s._warp_table.clone()
            assert (before[1::2] == 0).all()
            s._rebuild_skip_half()
            s._skip_stale = False
            fresh = skip.build_warp_skip_table(s.device_words, 5)
            assert torch.equal(s._warp_table[0::2], before[0::2])
            assert torch.equal(s._warp_table[1::2], fresh[1::2])
            assert s._warp_table[1::2].any()
            rebuilt += 1
        s.step()
    assert rebuilt > 0
