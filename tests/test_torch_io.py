"""The port's ``io`` copies against the JAX package's on the same bytes,
built in the test from a seed (no asset file): ``.vox`` parse and build
(non-cube, non-power-of-two, coordinate remap, random models), ``.rsvo``
levels, truncation and depth errors, both exporters' round trips and
errors, and ``load_file``'s dispatch, comparing pointers, values and
``top_mip``."""

import struct

import numpy as np
import pytest

from octree_tracer_tpu import io as jio
from octree_tracer_tpu.io import rsvo_export as jrsvo_export
from octree_tracer_tpu.io import vox as jvox
from octree_tracer_tpu.io import vox_export as jvox_export
from octree_tracer_tpu_torch import io as tio
from octree_tracer_tpu_torch import scenes
from octree_tracer_tpu_torch.core.cpu_octree import CpuOctree
from octree_tracer_tpu_torch.core.voxel import CHUNK_OFFSET, pack_rgb
from octree_tracer_tpu_torch.io import rsvo_export, vox, vox_export


def _make_vox(size, voxels, palette=None):
    """A minimal .vox: SIZE, XYZI and (unless ``palette`` is False) RGBA."""
    xyzi = struct.pack("<i", len(voxels)) + b"".join(struct.pack("<4B", *v) for v in voxels)

    def chunk(cid, content, children=b""):
        return cid + struct.pack("<ii", len(content), len(children)) + content + children

    inner = chunk(b"SIZE", struct.pack("<3i", *size)) + chunk(b"XYZI", xyzi)
    if palette is not False:
        pal = np.full(256, 0xFFFFFFFF, "<u4") if palette is None else palette
        inner += chunk(b"RGBA", np.asarray(pal, "<u4").tobytes())
    return b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", inner)


def _random_vox(seed, side, n, palette=True):
    rng = np.random.default_rng(seed)
    vox_ = rng.integers(0, side, (n, 3))
    col = rng.integers(1, 256, n)
    pal = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32) if palette else False
    return _make_vox((side,) * 3, [(*v, c) for v, c in zip(vox_, col)], pal)


def _make_rsvo(top_level, node_counts, masks):
    head = b"\x00" * 16 + bytes([top_level]) + b"\x00" * 3
    return head + b"".join(struct.pack("<I", c) for c in node_counts) + bytes(masks)


def _assert_tree_equal(a, b):
    np.testing.assert_array_equal(a.pointers, b.pointers)
    np.testing.assert_array_equal(a.values, b.values)
    assert int(a.top_mip) == int(b.top_mip)


VOX = {
    "coordinate_remap": lambda: _make_vox((4, 4, 4), [(0, 1, 2, 1)],
                                          np.full(256, 0x00050301, np.uint32)),
    "random8": lambda: _random_vox(0, 8, 60),
    "random16_duplicates": lambda: _random_vox(1, 16, 900),
    "random32_no_palette": lambda: _random_vox(2, 32, 500, palette=False),
    "one_voxel_side2": lambda: _make_vox((2, 2, 2), [(1, 0, 1, 7)]),
}


@pytest.mark.parametrize("case", sorted(VOX))
def test_vox_load_equals_jax(case):
    data = VOX[case]()
    size, voxels, palette = vox.parse_vox(data)
    jsize, jvoxels, jpalette = jvox.parse_vox(data)
    assert size == jsize
    np.testing.assert_array_equal(voxels, jvoxels)
    np.testing.assert_array_equal(palette, jpalette)
    _assert_tree_equal(vox.load_vox(data), jvox.load_vox(data))
    pos, ids = vox.load_structure(data)
    jpos, jids = jvox.load_structure(data)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(ids, jids)


def test_vox_coordinate_remap_cell():
    """vox (0, 1, 2) lands in cell (3, 2, 1), with the palette's colour."""
    tree = vox.load_vox(VOX["coordinate_remap"]())
    idx, depth, _ = tree.find_voxel([0.5, 0.0, -0.5])
    assert depth == 2 and tree.values[idx] == pack_rgb(1, 3, 5)


VOX_ERRORS = {
    "non_cube": lambda: _make_vox((4, 4, 2), []),
    "non_pow2": lambda: _make_vox((3, 3, 3), []),
    "not_vox": lambda: b"RIFF" + b"\x00" * 16,
    "no_model": lambda: b"VOX " + struct.pack("<i", 150) + b"MAIN" + struct.pack("<ii", 0, 0),
}


@pytest.mark.parametrize("case", sorted(VOX_ERRORS))
def test_vox_errors_equal_jax(case):
    data = VOX_ERRORS[case]()
    with pytest.raises(vox.VoxError) as a:
        vox.load_vox(data)
    with pytest.raises(jvox.VoxError) as b:
        jvox.load_vox(data)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_octree_leaves_equals_jax(seed):
    rng = np.random.default_rng(seed)
    depth = int(rng.integers(1, 7))
    cells = rng.integers(0, 1 << depth, (300, 3)).astype(np.uint32)
    ptrs = CHUNK_OFFSET + rng.integers(0, 9, 300).astype(np.uint32)
    vals = rng.integers(0, 1 << 24, 300).astype(np.uint32)
    _assert_tree_equal(vox.build_octree_leaves(cells, ptrs, vals, depth),
                       jvox.build_octree_leaves(cells, ptrs, vals, depth))
    with pytest.raises(vox.VoxError):
        vox.build_octree_leaves(cells, ptrs, vals, 0)


RSVO = {
    "single_level": (_make_rsvo(1, [1, 0], [0b00000101]), 1),
    "two_levels": (_make_rsvo(2, [1, 1, 0], [0b00000001, 0b00000011]), 2),
    "truncated": (_make_rsvo(2, [1, 1, 0], [0b00000001, 0b00000011]), 1),
    "three_levels": (_make_rsvo(3, [1, 2, 3, 0], [0b10000001, 0b00000011, 0b01000000,
                                                  0xFF, 0x0F, 0xF0]), 3),
    "short_stream": (_make_rsvo(3, [1, 2, 9, 0], [0b10000001, 0b00000011, 0xFF]), 3),
}


@pytest.mark.parametrize("case", sorted(RSVO))
def test_rsvo_load_equals_jax(case):
    data, depth = RSVO[case]
    _assert_tree_equal(tio.load_rsvo(data, depth), jio.load_rsvo(data, depth))


def test_rsvo_depth_too_large_raises_as_jax():
    data = _make_rsvo(1, [1, 0], [1])
    with pytest.raises(tio.RsvoError) as a:
        tio.load_rsvo(data, 5)
    with pytest.raises(jio.RsvoError) as b:
        jio.load_rsvo(data, 5)
    assert str(a.value) == str(b.value)


def _random_tree(seed, depth, n, colours=200):
    """``n`` random cells at ``depth`` in ``colours`` random non-black
    colours (at most 255 survive a .vox export unquantized)."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 1 << depth, (n, 3)).astype(np.uint32)
    palette = rng.integers(1, 1 << 24, colours).astype(np.uint32)
    return vox.build_octree(cells, palette[rng.integers(0, colours, n)], depth)


@pytest.mark.parametrize("depth", [3, 5, 7])
def test_rsvo_export_round_trip_equals_jax(depth):
    """save_rsvo's bytes equal JAX's; reloaded at every depth by both
    packages, the trees are equal, and at full depth the masks equal the
    original's."""
    tree = _random_tree(depth, depth, 400)
    data = rsvo_export.save_rsvo(tree)
    assert data == jrsvo_export.save_rsvo(tree)
    for d in range(1, depth + 1):
        _assert_tree_equal(tio.load_rsvo(data, d), jio.load_rsvo(data, d))
    back = tio.load_rsvo(data, depth)
    occ = lambda t: (t.pointers != CHUNK_OFFSET) | (t.values != 0)  # noqa: E731
    assert rsvo_export.save_rsvo(back) == data
    assert occ(back).sum() == occ(tree).sum()


def test_rsvo_export_rejects_as_jax():
    t = CpuOctree(0)
    t.put_in_voxel([0.9, 0.9, 0.9], 123, 1)
    t.put_in_voxel([-0.9, -0.9, -0.9], 9, 3)
    with pytest.raises(ValueError, match="uniform leaf depth"):
        rsvo_export.save_rsvo(t)
    with pytest.raises(ValueError, match="max_depth"):
        rsvo_export.save_rsvo(_random_tree(0, 5, 50), max_depth=3)


@pytest.mark.parametrize("seed,depth,n", [(0, 3, 40), (1, 5, 300), (2, 6, 1000)])
def test_vox_export_round_trip_equals_jax(seed, depth, n):
    """save_vox's bytes equal JAX's, and load_vox(save_vox(t)) is t word
    for word (no black voxels)."""
    tree = _random_tree(seed, depth, n)
    data = vox_export.save_vox(tree)
    assert data == jvox_export.save_vox(tree)
    assert vox_export.tree_depth(tree) == jvox_export.tree_depth(tree) == depth
    np.testing.assert_array_equal(vox.load_vox(data).to_words(), tree.to_words())
    cells, rgb = vox_export.tree_to_cells(tree, depth - 1)
    jcells, jrgb = jvox_export.tree_to_cells(tree, depth - 1)
    np.testing.assert_array_equal(cells, jcells)
    np.testing.assert_array_equal(rgb, jrgb)


def test_vox_export_quantizes_and_rejects_as_jax():
    """Over 255 colours quantize to the 255 most frequent, as JAX's; a tree
    deeper than 8 levels is refused."""
    tree = _random_tree(3, 4, 400, colours=400)
    data = vox_export.save_vox(tree, 4)
    assert data == jvox_export.save_vox(tree, 4)
    _assert_tree_equal(vox.load_vox(data), jvox.load_vox(data))
    deep = CpuOctree(0)
    deep.put_in_voxel([0.5, 0.5, 0.5], pack_rgb(1, 2, 3), 9)
    with pytest.raises(ValueError, match="256"):
        vox_export.save_vox(deep)


def test_load_file_dispatch_equals_jax(tmp_path):
    """load_file reads .vox, .rsvo (at the depth asked) and world .bin
    chunks as JAX's does, and refuses any other extension."""
    tree = _random_tree(4, 5, 300)
    paths = {".vox": vox_export.save_vox(tree), ".rsvo": rsvo_export.save_rsvo(tree),
             ".bin": scenes.shell_chunk(4).to_bin()}
    for ext, data in paths.items():
        p = tmp_path / f"scene{ext.upper() if ext == '.vox' else ext}"
        p.write_bytes(data)
        _assert_tree_equal(tio.load_file(str(p), 4), jio.load_file(str(p), 4))
    (tmp_path / "x.txt").write_bytes(b"")
    with pytest.raises(ValueError, match="Unknown file type"):
        tio.load_file(str(tmp_path / "x.txt"))
