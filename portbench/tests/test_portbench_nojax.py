"""No JAX on the card: the run's check of sys.modules tells the port from
the JAX package by whole top-level names, and no file of the benchmark
imports either."""

import ast
import os

import pytest

from portbench import harness


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["octree_tracer_tpu_torch", "octree_tracer_tpu_torch.render.tracer", "torch",
              "jaxtyping", "octree_tracer_tpu_torchx", "numpy"]
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules(loaded + ["octree_tracer_tpu.render"]) == [
        "octree_tracer_tpu.render"]
    assert harness.forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client"]


def sources():
    for d, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, harness.BENCH_DIR))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert harness.forbidden_modules(names) == []
    if "/reference/" in path:  # the reference imports nothing of the program either
        assert not [n for n in names if n.split(".")[0] == "octree_tracer_tpu_torch"]
    text = open(path).read()
    assert "chip_smoke" not in text.replace("chip_smoke.py", "") or "/tests/" in path
