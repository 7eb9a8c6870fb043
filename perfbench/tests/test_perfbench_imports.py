"""No module of the benchmark imports JAX or the JAX package, comparing each
import's top-level name whole, the reference imports nothing of the port,
and only system.py, programs/*.py and the fault tests import the port."""

from __future__ import annotations

import ast
import sys
import types
from pathlib import Path

from perfbench import run
from perfbench.manifest import PACKAGE

BANNED = {"jax", "jaxlib", "flax", "million_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not imported(f) & BANNED, f


def test_reference_imports_nothing_of_the_port():
    files = sorted((PACKAGE / "reference").rglob("*.py"))
    assert files
    for f in files:
        names = imported(f)
        assert "million_tpu_torch" not in names and not names & BANNED, f
        src = f.read_text()
        assert not any(m in src for m in ("perfbench.system", "perfbench.driver", "perfbench.programs")), f


def test_only_system_and_the_fault_tests_import_the_port():
    users = {f.relative_to(PACKAGE).as_posix() for f in PACKAGE.rglob("*.py")
             if "million_tpu_torch" in imported(f)}
    assert {u for u in users if not u.startswith("programs/")} <= {"system.py", "tests/faults.py"}, users


def test_the_result_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "million_tpu_torch_extra", types.ModuleType("million_tpu_torch_extra"))
    assert not run.banned_modules() & {"million_tpu_torch_extra"}
    monkeypatch.setitem(sys.modules, "million_tpu.cli", types.ModuleType("million_tpu.cli"))
    assert run.banned_modules() == {"million_tpu"}
