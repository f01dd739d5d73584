"""What the benchmark imports, and that it refuses a host without a card."""

import ast
import os
import subprocess
import sys

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "image_stitching_tpu"}
# The yardstick: these import nothing of the program.
INDEPENDENT = ("reference.py", "scene.py", "yardstick.py")


def _imports(path):
    """Top-level names of every module a file imports (relative imports
    excluded)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for dirpath, _, files in os.walk(run.BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_jax_anywhere():
    found = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: v for p, v in found.items() if v}


def test_names_compared_whole():
    # The port's name begins with the JAX package's, and is allowed.
    assert "image_stitching_tpu_torch".split(".")[0] not in FORBIDDEN
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "image_stitching_tpu")


def test_reference_takes_nothing_of_the_program():
    for name in INDEPENDENT:
        mods = set(_imports(os.path.join(run.BENCH, name)))
        assert "image_stitching_tpu_torch" not in mods, name


def test_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "ring8.stitch",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
