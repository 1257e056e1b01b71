"""The inputs of each configuration, made by the benchmark and handed to
the program, chosen by the configuration file's ``scene``:

- ``shell``: the deep shell's pool words, built by the reference
  (``reference/shell.py``); as a streaming world, the same words as the
  world's root chunk with its mip tree, through the program's ``World``;
- ``island``: the generated island world, written by the program's
  ``World.generate_world`` into a fixed directory under ``TMPDIR``
  (the generator reads no seed, so every run writes the same world).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from .reference import shell


def pool_words(settings: dict) -> np.ndarray:
    """u32 pool words of a static scene."""
    if settings["scene"] != "shell":
        raise ValueError(f"no static pool for scene {settings['scene']!r}")
    return shell.shell_words(settings["depth"])


def scratch_dir(name: str) -> str:
    """``TMPDIR/portbench_<name>``, emptied."""
    path = os.path.join(tempfile.gettempdir(), "portbench_" + name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def generate_island(settings: dict, path: str, device) -> None:
    """Generate the island world into ``path``."""
    from octree_tracer_tpu_torch.gen.procedural import Procedural
    from octree_tracer_tpu_torch.world.world import World

    proc = Procedural(chunk_depth=settings["chunk_depth"], structures=settings["structures"],
                      device=device)
    world = World(load_blocks=settings["load_blocks"])
    try:
        world.generate_world(path, proc, world_depth=settings["world_depth"])
    finally:
        world._pool.shutdown(wait=True)


def world(settings: dict, device):
    """The streaming World of a configuration and the words the benchmark
    made for it: the shell as the World's root chunk with its mip tree (and
    the shell's words), or the island generated under ``TMPDIR`` and loaded
    back, its chunks streaming in from there (and None: the reference reads
    the chunk files)."""
    from octree_tracer_tpu_torch import scenes as program_scenes
    from octree_tracer_tpu_torch.world.world import World

    if settings["scene"] == "shell":
        words = pool_words(settings)
        w = World(load_blocks=False)
        w.chunks[0] = program_scenes.chunk_from_words(words)
        w.generate_mip_tree(0)
        return w, words
    if settings["scene"] == "island":
        path = scratch_dir("island_world")
        generate_island(settings, path, device)
        os.sync()  # the world's gigabyte on disk before the window, not during it
        return World.load_world(path, load_blocks=settings["load_blocks"]), None
    raise ValueError(f"no world for scene {settings['scene']!r}")
