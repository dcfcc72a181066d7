"""No module of the benchmark imports JAX or the JAX package, compared by
the whole top-level name; the reference imports nothing of the program
either."""

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "gpubench")
NEVER = {"jax", "jaxlib", "flax", "krakenuniq_tpu", "bench", "chip_smoke"}


def _sources():
    for d, dirs, files in os.walk(BENCH):
        dirs[:] = [x for x in dirs if not x.startswith("_")]
        yield from (os.path.join(d, f) for f in sorted(files) if f.endswith(".py"))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax(path):
    never = NEVER | ({"krakenuniq_tpu_torch"} if os.sep + "reference" + os.sep in path else set())
    found = set(_imports(path)) & never
    assert not found, f"{path} imports {found}"
