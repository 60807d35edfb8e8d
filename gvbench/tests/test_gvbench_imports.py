"""Nothing the benchmark runs imports JAX, Flax or the JAX package, and
the reference imports nothing of the program: top-level names compared
whole (``gvamp_tpu_torch`` begins with ``gvamp_tpu``)."""

from __future__ import annotations

import ast
import pathlib

import pytest

from gvbench import yardstick

ROOT = pathlib.Path(yardstick.HERE)
SOURCES = sorted(p for p in ROOT.rglob("*.py")
                 if "tests" not in p.relative_to(ROOT).parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax",
                                          "gvamp_tpu"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_only_drivers_import_the_program(path):
    if path.parent.name != "drivers":
        assert "gvamp_tpu_torch" not in top_level_imports(path)


def test_forbidden_modules_compares_whole_names():
    assert yardstick.forbidden_modules(
        ["gvamp_tpu_torch", "gvamp_tpu_torch.linear", "numpy"]) == []
    assert yardstick.forbidden_modules(
        ["gvamp_tpu.data", "jax", "jaxlib.xla", "flax.linen", "jaxtyping"]
    ) == ["flax.linen", "gvamp_tpu.data", "jax", "jaxlib.xla"]
