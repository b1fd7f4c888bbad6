"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Names are compared whole by their
top-level part: the program's name, tpu_pathtracer_torch, only begins with
the JAX package's."""

import ast
import subprocess
import sys
import types

from ptbench import run
from tiny import ROOT

BENCH = ROOT / "ptbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert set(_imports(path)) <= {"__future__", "dataclasses", "math", "numpy", "torch"}, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_pathtracer_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlibrary", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_pathtracer.render", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax", "tpu_pathtracer"]


def test_a_whole_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'ptbench/tests'); from tiny import run_tiny;"
            "from ptbench import run; run_tiny('default_scene.interactive', trace=True);"
            "run_tiny('default_scene.invert'); print(run.forbidden_modules())")
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"
