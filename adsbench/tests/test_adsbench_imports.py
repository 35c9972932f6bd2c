"""No module of the benchmark imports JAX or the JAX package, and the
yardstick (traffic, reference, comparison, bounds) imports nothing of
the program under test. Names are compared whole, by their top-level
part: the port's `airjax_torch` is not `airjax`."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "airjax"}
MODULES = sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py"))


def top_level_imports(source: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", MODULES)
def test_no_jax(rel):
    assert not top_level_imports((BENCH / rel).read_text()) & BANNED


@pytest.mark.parametrize("rel", [m for m in MODULES if m.startswith("yardstick/")])
def test_yardstick_imports_no_program(rel):
    assert "airjax_torch" not in top_level_imports((BENCH / rel).read_text())


def test_names_are_compared_whole():
    assert top_level_imports("import airjax_torch.runner\nfrom airjax_torch import pipeline") == {"airjax_torch"}
    assert top_level_imports("import jax.numpy as jnp") & BANNED == {"jax"}
    assert top_level_imports("from airjax.golden import magnitude") & BANNED == {"airjax"}


def test_run_refuses_banned_modules(monkeypatch):
    import sys
    import types

    from adsbench import harness

    monkeypatch.setitem(sys.modules, "airjax_torch_fake", types.ModuleType("airjax_torch_fake"))
    assert "airjax" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "airjax.fake", types.ModuleType("airjax.fake"))
    assert "airjax" in harness.banned_modules()
