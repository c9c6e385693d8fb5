"""Nothing the benchmark runs imports JAX or the JAX package, judged by
whole top-level module names; the references import nothing of the
program."""
from __future__ import annotations

import ast

import pytest

from benchhelp import ROOT

FILES = sorted(p for p in (ROOT / "benchmark").rglob("*.py")
               if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "astrild_tpu"}


def _tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not FORBIDDEN.intersection(_tops(path))


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert "astrild_tpu_torch" not in set(_tops(path))
    assert "astrild_tpu_torch" not in path.read_text()


def test_whole_names():
    assert "astrild_tpu_torch".split(".")[0] not in FORBIDDEN
