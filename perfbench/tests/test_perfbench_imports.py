"""Nothing under ``perfbench/`` imports JAX or the reference package the
port was made from, and the plain reference imports nothing of the
program.  Names are compared whole at the top level: ``repro_torch``
begins with ``repro`` and is not it."""
from __future__ import annotations

import ast

import pytest

from perfbench.tests.helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted((ROOT / "perfbench").rglob("*.py"))


def _imports(path) -> list[str]:
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.append(str(node.args[0].value))
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted((ROOT / "perfbench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("repro_torch", "perfbench", "torch")]
    assert not bad, f"{path} imports {bad}"


def test_the_guard_compares_whole_names(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro_torch\nfrom repro_torch.core import cost\n")
    assert not [m for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    p.write_text("from repro.core import cost\n")
    assert [m for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
