"""Procedural generation in the port: the noise and SDF functions, the block
grid (the plain version of kernel K7), ``Procedural`` and
``World.generate_world`` against the JAX package's, and a port Session
against a JAX Session on a generated world.

JAX's reference here is its functions as written, evaluated op by op
(``jax.disable_jit``): the port repeats them operation for operation and
equals them bit for bit. Compiled by XLA's CPU build, the same functions
contract multiply-adds into FMAs differently in different fusions, so two
copies of one simplex ``x0`` component can compare unequal; where a grid
point ties two components (common on a regular grid), the compiled noise
takes another corner order and v moves by up to about 0.07. The compiled
``_block_grid`` therefore differs from its own op-by-op evaluation, and so
from the port, on a few cells in 10^4; ``test_block_grid_equals_jax`` bounds
that share.
"""

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_tracer_tpu import native as jnative
from octree_tracer_tpu.app.session import Session as JSession
from octree_tracer_tpu.gen import noise as jnoise
from octree_tracer_tpu.gen import procedural as jproc
from octree_tracer_tpu.gen.sdf import island_sdf as jisland_sdf
from octree_tracer_tpu.world.world import World as JWorld
from octree_tracer_tpu_torch import native, state
from octree_tracer_tpu_torch.app.session import Session
from octree_tracer_tpu_torch.gen import noise, procedural
from octree_tracer_tpu_torch.gen.sdf import island_sdf
from octree_tracer_tpu_torch.world.world import World

# Noise, SDF and rotation values are of order 1; JAX's jnp.linalg.norm and
# reductions inside them round a few ulps apart from the port's left-to-right
# sums. |port - jax| <= ATOL + RTOL * |jax|.
ATOL, RTOL = 2e-6, 2e-6
# The fract-sin hash multiplies sin by 43758.5453: a one-ulp sin difference
# moves the fraction by up to ~4e-3, and a fraction near 0 or 1 wraps.
HASH_TOL = 1e-2
# Share of cells on which XLA's compiled _block_grid may differ (module
# docstring): measured 9 / 32,768 (corner, chunk_depth 5), 41 / 262,144
# (corner, 6) and 38 / 32,768 (the (-0.25, -0.5, 0.25) chunk at base 3).
COMPILED_BUDGET = 2e-3

PTS = np.random.default_rng(0).uniform(-2, 2, (4096, 3)).astype(np.float32)
AXIS = np.array([0.3, -0.5, 0.8], np.float32)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


FUNCS = {
    "simplex_noise3": (jnoise.simplex_noise3, noise.simplex_noise3),
    "sdf_box": (lambda p: jnoise.sdf_box(p, (0.7, 0.1, 0.7)),
                lambda p: noise.sdf_box(p, (0.7, 0.1, 0.7))),
    "sdf_cone": (lambda p: jnoise.sdf_cone(p, (0.5, 0.5), 0.9),
                 lambda p: noise.sdf_cone(p, (0.5, 0.5), 0.9)),
    "smin": (lambda p: jnoise.smin(p[:, 0], p[:, 1], 0.2),
             lambda p: noise.smin(p[:, 0], p[:, 1], 0.2)),
    "smoothstep": (lambda p: jnoise.smoothstep(0.0, 0.2, p[:, 1]) + jnoise.smoothstep(
        0.0, -1.5, p[:, 2]), lambda p: noise.smoothstep(0.0, 0.2, p[:, 1])
        + noise.smoothstep(0.0, -1.5, p[:, 2])),
    "rotate_x": (lambda p: jnoise.rotate_x(p, 0.7), lambda p: noise.rotate_x(p, 0.7)),
    "rotate_y": (lambda p: jnoise.rotate_y(p, -1.3), lambda p: noise.rotate_y(p, -1.3)),
    "rotate_z": (lambda p: jnoise.rotate_z(p, 2.1), lambda p: noise.rotate_z(p, 2.1)),
    "rotate": (lambda p: jnoise.rotate(p, _j(AXIS), 1.1), lambda p: noise.rotate(p, AXIS, 1.1)),
    "island_sdf": (jisland_sdf, island_sdf),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_noise_and_sdf_equal_jax(name):
    jf, tf = FUNCS[name]
    want = np.asarray(jf(_j(PTS)))
    got = tf(_t(PTS)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_hash_rand_equals_jax():
    want = np.asarray(jnoise.hash_rand(_j(PTS)))
    got = noise.hash_rand(_t(PTS)).numpy()
    d = np.abs(got - want)
    assert np.minimum(d, 1.0 - d).max() <= HASH_TOL
    assert ((got >= 0) & (got < 1)).all()


def test_floor_mod_is_jax_remainder():
    x = np.concatenate([np.arange(-900, 900, dtype=np.float32),
                        np.array([-0.0, 25558293.0, -25558293.0], np.float32)])
    np.testing.assert_array_equal(noise.floor_mod(_t(x), 289.0).numpy(),
                                  np.asarray(_j(x) % 289.0))


def _jax_grid(pos, depth, base, packed=False):
    """JAX's _block_grid(_packed) op by op, in one x-slab (the slab count
    changes no value)."""
    fn = jproc._block_grid_packed if packed else jproc._block_grid
    with jax.disable_jit():
        return np.asarray(fn(_j(np.asarray(pos, np.float32)), depth, base, x_slabs=1))


# The corner chunk of a depth-1 world, and two interior chunks.
GRIDS = [(5, (-1.0, -1.0, -1.0), 1), (6, (-1.0, -1.0, -1.0), 1),
         (5, (0.0, -1.0, -0.5), 2), (6, (-0.5, -0.25, 0.0), 2),
         (5, (-0.25, -0.5, 0.25), 3), (6, (0.0, -0.5, -0.5), 1)]


@pytest.mark.parametrize("depth,pos,base", GRIDS)
def test_block_grid_equals_jax(depth, pos, base):
    want = _jax_grid(pos, depth, base)
    got = procedural.block_grid(pos, depth, base, device="cpu").numpy()
    assert got.shape == (1 << depth,) * 3 and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).sum() < got.size
    assert set(np.unique(got)) <= {0, procedural.BLOCK_STONE, procedural.BLOCK_GRASS}
    compiled = np.asarray(jproc._block_grid(_j(np.asarray(pos, np.float32)), depth, base))
    assert (compiled != got).mean() <= COMPILED_BUDGET


@pytest.mark.parametrize("depth,pos,base", GRIDS[:3])
def test_block_grid_packed_equals_jax(depth, pos, base):
    want = _jax_grid(pos, depth, base, packed=True)
    got = procedural.block_grid_packed(pos, depth, base, device="cpu")
    assert got.dtype == torch.int32 and got.shape == ((1 << 3 * depth) // 16,)
    np.testing.assert_array_equal(state.to_numpy_u32(got), want)
    grid = procedural.block_grid(pos, depth, base, device="cpu")
    assert torch.equal(procedural.unpack_grid(got, depth), grid)
    assert torch.equal(procedural.pack_grid(grid), got)


def test_block_grid_small_chunks_and_packing_limit():
    for depth in (1, 3):
        want = _jax_grid((-1.0, -0.25, -1.0), depth, 1)
        got = procedural.block_grid((-1.0, -0.25, -1.0), depth, 1, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        procedural.block_grid_packed((-1.0, -1.0, -1.0), 1, 1, device="cpu")


# The 8 chunk corners of the CLI's default world (world_depth 1).
DEFAULT_CORNERS = [(x, y, z) for x in (-1.0, 0.0) for y in (-1.0, 0.0) for z in (-1.0, 0.0)]


# Chunks far from the origin but inside the range, where the lattice corners
# and not the permutation bound the floor-mod inputs.
FAR_INSIDE = [(1.0e7, -3.0e6, 7.5e6), (-2.0e8, 1.0e3, 5.0)]


@pytest.mark.parametrize("pos,depth", [(p, 5) for p in DEFAULT_CORNERS]
                         + [(p, 2) for p in FAR_INSIDE])
def test_floor_mod_inputs_inside_k7_exact_range(pos, depth, monkeypatch):
    """Every ``x % 289`` of the plain block grid is of an integer-valued
    float inside ``k7_exact_range``, the range on which K7's integer
    floor-mod equals the float one."""
    seen = []
    floor_mod = noise.floor_mod

    def spy(x, m):
        seen.append((bool(torch.equal(x, torch.trunc(x))), float(x.abs().max())))
        return floor_mod(x, m)

    monkeypatch.setattr(noise, "floor_mod", spy)
    procedural.block_grid_plain(pos, depth, 1)
    # Each x-slab: 4 simplex evaluations, 3 lattice corners and 12 permutations.
    assert len(seen) == min(procedural.X_SLABS, 1 << depth) * 4 * 15
    assert all(integral for integral, _ in seen)
    top = max(m for _, m in seen)
    bound = procedural.k7_exact_range(pos, depth, 1)
    assert top <= bound < procedural.K7_EXACT_LIMIT
    if pos in DEFAULT_CORNERS:
        assert bound == procedural.PERMUTE_MAX == procedural.k7_exact_range(pos, 9, 1)
    else:
        assert top > procedural.PERMUTE_MAX


def test_noise_scale_max_is_the_sdfs_largest(monkeypatch):
    """``k7_exact_range`` scales coordinates by ``_NOISE_SCALE_MAX``: no
    noise input of ``island_sdf`` exceeds it times its coordinate, and one
    octave reaches it, so it follows the SDF's octave scales."""
    from octree_tracer_tpu_torch.gen import sdf

    ratios = []
    simplex = sdf.simplex_noise3

    def spy(v):
        ratios.append(float((v.double().abs() / pos.double().abs()).max()))
        return simplex(v)

    monkeypatch.setattr(sdf, "simplex_noise3", spy)
    pos = torch.from_numpy(PTS)
    island_sdf(pos)
    assert len(ratios) == 4
    assert max(ratios) <= procedural._NOISE_SCALE_MAX * (1 + 2.0 ** -23)
    assert max(ratios) == pytest.approx(procedural._NOISE_SCALE_MAX, rel=1e-6)


def test_default_corners_are_generate_worlds(tmp_path):
    """The corners these tests and ``probes/kernel_steps.py`` use are the
    chunks ``generate_world`` dispatches for the default world, in order."""
    from octree_tracer_tpu_torch.probes import kernel_steps

    class Recorder:
        def __init__(self):
            self.corners = []

        def dispatch_chunk(self, pos, base_depth):
            self.corners.append((tuple(float(v) for v in pos), base_depth))

        def finish_chunk(self, handle):
            return None

    rec = Recorder()
    World(load_blocks=False).generate_world(str(tmp_path / "w"), rec, world_depth=1)
    assert rec.corners == [(c, 1) for c in DEFAULT_CORNERS]
    assert kernel_steps.CORNERS == DEFAULT_CORNERS


FAR = [(3e8, 0.0, 0.0), (0.0, -1e9, 0.0), (0.0, 0.0, 2.5e8), (float("nan"), 0.0, 0.0),
       (0.0, float("inf"), 0.0)]


@pytest.mark.parametrize("pos", FAR)
def test_k7_range_check_rejects_far_chunks(pos):
    """A chunk whose lattice corners could reach 2^31 is past K7's exact
    range: the wrapper raises before it launches (on a CUDA device; here
    there is none to launch on)."""
    assert not procedural.k7_exact_range(pos, 9, 1) < procedural.K7_EXACT_LIMIT
    with pytest.raises(ValueError, match="exact range"):
        procedural.block_grid_packed(pos, 9, 1, device="cuda")
    with pytest.raises(ValueError, match="exact range"):
        procedural.block_grid(pos, 4, 1, device="cuda")


@pytest.fixture
def fast_jax_gen(monkeypatch):
    """JAX's generator evaluated op by op in one x-slab."""
    monkeypatch.setattr(jproc, "_block_grid_packed",
                        functools.partial(jproc._block_grid_packed, x_slabs=1))
    with jax.disable_jit():
        yield


@pytest.mark.parametrize("path", ["packed", "leaves"])
def test_generate_chunk_equals_jax(path, monkeypatch, fast_jax_gen):
    """Pointers and values of a generated chunk: the native dense build, and
    without the native library the NumPy level build."""
    if path == "leaves":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(jproc, "_block_grid", functools.partial(jproc._block_grid,
                                                                    x_slabs=1))
    for pos, base in (((-1.0, -1.0, -1.0), 1), ((0.0, -0.5, -0.5), 2)):
        a = procedural.Procedural(chunk_depth=4, device="cpu").generate_chunk(pos, base)
        b = jproc.Procedural(chunk_depth=4).generate_chunk(np.asarray(pos, np.float32), base)
        np.testing.assert_array_equal(a.pointers, b.pointers)
        np.testing.assert_array_equal(a.values, b.values)
    empty = procedural.Procedural(chunk_depth=3, device="cpu").generate_chunk(
        (0.5, 0.5, 0.5), 2)
    assert empty is None


def test_procedural_device_and_structures(monkeypatch, tmp_path):
    """Structures need their asset files, as JAX's do: a chunk with grass
    and no ``structures/`` raises; the device defaults to the card."""
    missing = procedural.Procedural(chunk_depth=5, structures=True, tree_probability=1.0,
                                    device="cpu", asset_root=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        missing.generate_chunk((-1.0, -1.0, -1.0), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        procedural.Procedural(chunk_depth=4)
    p = procedural.Procedural(chunk_depth=4, device="cpu")
    p.generate_chunk((-1.0, -1.0, -1.0), 1)
    assert p.timings[0]["nodes"] > 8 and p.timings[0]["build_s"] >= 0.0


@pytest.fixture
def generated(tmp_path, monkeypatch):
    """A chunk_depth 4, world_depth 1 world generated by both packages (JAX
    op by op in one x-slab)."""
    monkeypatch.setattr(jproc, "_block_grid_packed",
                        functools.partial(jproc._block_grid_packed, x_slabs=1))
    with jax.disable_jit():
        JWorld(load_blocks=False).generate_world(
            str(tmp_path / "jax"), jproc.Procedural(chunk_depth=4), world_depth=1)
    done = []
    World(load_blocks=False).generate_world(
        str(tmp_path / "port"), procedural.Procedural(chunk_depth=4, device="cpu"),
        world_depth=1, progress=lambda i, n: done.append((i, n)))
    assert done[-1] == (8, 8)
    return tmp_path


def test_generate_world_files_equal_jax(generated):
    files = sorted(os.listdir(generated / "jax"))
    assert sorted(os.listdir(generated / "port")) == files and "0.bin" in files
    assert len(files) > 2
    for f in files:
        assert (generated / "port" / f).read_bytes() == (generated / "jax" / f).read_bytes(), f
    w = World.load_world(str(generated / "port"), load_blocks=False)
    jw = JWorld.load_world(str(generated / "jax"), load_blocks=False)
    np.testing.assert_array_equal(w.chunks[0].pointers, jw.chunks[0].pointers)
    np.testing.assert_array_equal(w.chunks[0].values, jw.chunks[0].values)
    cid = int(f"{files[1].split('.')[0]}")
    w.load_chunk(cid)
    w.wait_for_loads()
    assert len(w.chunks[cid]) > 8


def _jax_wait(world):
    while world.loading:
        time.sleep(0.0005)


def test_session_on_generated_world_equals_jax(generated):
    """A port Session and a JAX Session on the generated world, stepped
    together, each waiting for its chunk loads after a step: equal images,
    stats, pools and resident chunks at every step, through chunk loads and,
    after the turn, collapses and evictions."""
    a = Session(World.load_world(str(generated / "port"), load_blocks=False), 32, 32, pool_capacity=65536,
                device="cpu")
    b = JSession(JWorld.load_world(str(generated / "port"), load_blocks=False), 32, 32,
                 pool_capacity=65536)
    for s in (a, b):
        s.character.pos = np.array([0.25, 0.35, -2.3], np.float32)
        s.character.look = np.array([-0.12, -0.17, 1.0], np.float32)
        s.settings.fov = 70.0
    loads, evictions, totals = 0, 0, {"subdivided": 0, "collapsed": 0}
    before = set(a.world.chunks)
    for i in range(12):
        if i == 8:
            for s in (a, b):
                s.character.turn(2400.0, 0.0, fov=70.0)
        img_a, _, st_a = a.step()
        img_b, _, st_b = b.step()
        a.world.wait_for_loads()
        _jax_wait(b.world)
        np.testing.assert_array_equal(img_a.numpy(), np.asarray(img_b), err_msg=f"step {i}")
        assert st_a == st_b, f"step {i}: {st_a} vs {st_b}"
        np.testing.assert_array_equal(state.to_numpy_u32(a.device_words),
                                      np.asarray(b.device_words), err_msg=f"step {i}")
        now = set(a.world.chunks)
        assert now == set(b.world.chunks), f"step {i}"
        loads += len(now - before)
        evictions += len(before - now)
        before = now
        for k in totals:
            totals[k] += st_a[k]
    assert loads > 0 and totals["subdivided"] > 0
    assert evictions > 0 and totals["collapsed"] > 0


@pytest.fixture(scope="module")
def asset_root(tmp_path_factory):
    """A synthetic asset root, the same for both packages; JAX's structure
    loader binds its root at import, so the test hands it this one."""
    from octree_tracer_tpu_torch import scenes

    return scenes.write_asset_root(str(tmp_path_factory.mktemp("assets")), seed=5)


@pytest.fixture
def jax_structures(asset_root, monkeypatch):
    from octree_tracer_tpu.gen import structures as jst
    from octree_tracer_tpu_torch.gen import structures as tst

    load = jst.load_structure_file
    monkeypatch.setattr(jst, "load_structure_file",
                        lambda name, root=None: load(name, asset_root))
    yield jst, tst
    load.cache_clear()
    tst.load_structure_file.cache_clear()


@pytest.mark.parametrize("seed", [0, 7])
def test_place_and_stamp_structures_equal_jax(seed, asset_root, jax_structures):
    """``place_structures`` (crystals on the centre column, seeded trees)
    and ``stamp_structure`` give the arrays and counts JAX's give, through
    the native batch insert and through the ``put_in_block`` loop."""
    jst, tst = jax_structures
    from octree_tracer_tpu.core import CpuOctree as JCpuOctree
    from octree_tracer_tpu_torch.core.cpu_octree import CpuOctree

    depth = 5
    grid = procedural.block_grid_plain((-1.0, -1.0, -1.0), depth, 1).numpy()
    packed = procedural.pack_grid(torch.from_numpy(grid)).numpy()
    grass = tst.grass_cells_from_packed(packed, depth)
    np.testing.assert_array_equal(grass, jst.grass_cells_from_packed(packed.view(np.uint32),
                                                                     depth))
    np.testing.assert_array_equal(grass, np.argwhere(grid == procedural.BLOCK_GRASS))
    ptrs, vals = native.build_dense(packed, depth)
    for use_native in (True, False):
        with pytest.MonkeyPatch.context() as m:
            if not use_native:
                m.setattr(native, "available", lambda: False)
            a = CpuOctree.from_arrays(ptrs, vals)
            b = JCpuOctree.from_arrays(ptrs, vals)
            na = tst.place_structures(a, grass, depth, seed=seed, probability=0.2,
                                      asset_root=asset_root)
            nb = jst.place_structures(b, grass, depth, seed=seed, probability=0.2)
        assert na == nb > 0
        np.testing.assert_array_equal(a.pointers, b.pointers)
        np.testing.assert_array_equal(a.values, b.values)
    offs, blocks = tst.load_structure_file("tree", asset_root)
    a = CpuOctree.from_arrays(ptrs, vals)
    b = JCpuOctree.from_arrays(ptrs, vals)
    base = np.array([0.1, -0.2, 0.3], np.float32)
    assert (tst.stamp_structure(a, base, offs, blocks, depth)
            == jst.stamp_structure(b, base, offs, blocks, depth) > 0)
    np.testing.assert_array_equal(a.pointers, b.pointers)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_scatter_trees_equals_jax(seed, use_native, asset_root, jax_structures, monkeypatch):
    """``scatter_trees`` (seeded trees on any grass cell) gives the arrays
    and count JAX's gives, through the native batch insert and through the
    ``put_in_block`` loop."""
    jst, tst = jax_structures
    from octree_tracer_tpu.core import CpuOctree as JCpuOctree
    from octree_tracer_tpu_torch.core.cpu_octree import CpuOctree

    depth = 5
    grid = procedural.block_grid_plain((-1.0, -1.0, -1.0), depth, 1).numpy()
    packed = procedural.pack_grid(torch.from_numpy(grid)).numpy()
    grass = tst.grass_cells_from_packed(packed, depth)
    ptrs, vals = native.build_dense(packed, depth)
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    a = CpuOctree.from_arrays(ptrs, vals)
    b = JCpuOctree.from_arrays(ptrs, vals)
    na = tst.scatter_trees(a, grass, depth, seed=seed, probability=0.3,
                           asset_root=asset_root)
    nb = jst.scatter_trees(b, grass, depth, seed=seed, probability=0.3)
    assert na == nb > 0
    np.testing.assert_array_equal(a.pointers, b.pointers)
    np.testing.assert_array_equal(a.values, b.values)
    assert tst.scatter_trees(a, grass[:0], depth, asset_root=asset_root) == 0


def test_generated_world_with_structures_equals_jax(tmp_path, asset_root, jax_structures,
                                                    fast_jax_gen):
    """A chunk_depth 5, world_depth 1 world with the block library and
    structures: every chunk file byte-equal to JAX's, and blocks stamped."""
    p = procedural.Procedural(chunk_depth=5, structures=True, device="cpu",
                              asset_root=asset_root)
    World(asset_root=asset_root).generate_world(str(tmp_path / "port"), p, world_depth=1)
    JWorld(asset_root=asset_root).generate_world(
        str(tmp_path / "jax"), jproc.Procedural(chunk_depth=5, structures=True), world_depth=1)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files and len(files) == 9
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert sum(t["stamped"] for t in p.timings) > 0
