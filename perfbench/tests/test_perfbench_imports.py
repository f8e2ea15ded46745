"""Nothing under perfbench/ imports JAX, the JAX package or chip_smoke, by
top-level name compared whole (the port's name begins with the JAX
package's); the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from perfbench.harness import core

PERFBENCH = Path(core.PERFBENCH)
FILES = sorted(PERFBENCH.rglob("*.py"))


def _tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.add(arg.value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(PERFBENCH)) for p in FILES])
def test_no_jax_nor_the_jax_package(path):
    assert not _tops(path) & set(core.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mickey_tpu_torch" not in _tops(path)
    assert "perfbench" not in _tops(path)  # only its own modules, relatively


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "mickey_tpu_torch_extra", types.ModuleType("mickey_tpu_torch_extra"))
    assert "mickey_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mickey_tpu.config", types.ModuleType("mickey_tpu.config"))
    assert core.forbidden_modules() == ["mickey_tpu"]
