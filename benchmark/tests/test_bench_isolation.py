"""What the harness may import and where it may run: no file of the
benchmark imports ``jax``, ``jaxlib``, ``flax``, ``optax`` or the JAX
package (top-level names compared whole, so the port's
``brainmagick_tpu_torch`` is allowed); only the program entries
(``harness/program.py``, ``programs/*.py``) name the port, and none of
them reaches the reference; the reference and the readers reach no
program entry; a run refuses a process holding one of them; and the
command exits non-zero, printing no result, without a card."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cell
from conftest import REPO

BENCH = REPO / "benchmark"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        found = _imports(path) & cell.FORBIDDEN
        assert not found, (path, found)


PORT = "brainmagick_tpu_torch"


def _reached(tree: ast.AST, package: list) -> set:
    """The dotted names of what the module `tree` of `package` imports
    (relative imports resolved) and of the benchmark's modules it loads
    by path (``spec.module(kind, name)``: ``benchmark.<kind>.<name>``)."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] \
                if node.level else []
            base = ".".join(base + ([node.module] if node.module else []))
            names.update(f"{base}.{a.name}" for a in node.names)
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "module"):
            words = [a.value for a in node.args[:2]
                     if isinstance(a, ast.Constant)]
            names.add(".".join(["benchmark", *map(str, words)]))
    return names


def _isolation_faults(bench: Path) -> list:
    """Each file under `bench` (its tests aside) that breaks the rule,
    with the reason: only the program entries name the port; no entry
    reaches the reference; the reference and the readers reach no entry,
    by import, by path or through a cell's ``program``."""
    entries = {bench / "harness" / "program.py",
               *(bench / "programs").glob("*.py")}
    faults = []
    for path in sorted(bench.rglob("*.py")):
        where = path.relative_to(bench)
        if where.parts[0] == "tests":
            continue
        text = path.read_text()
        tree = ast.parse(text)
        reached = _reached(tree, ["benchmark", *where.parts[:-1]])
        if path in entries:
            if any(n.startswith("benchmark.reference") for n in reached):
                faults.append((str(where), "an entry reaches the reference"))
        elif PORT in text:
            faults.append((str(where), "names the port"))
        if where.parts[0] in ("reference", "metrics"):
            if any({"program", "programs"} & set(n.split("."))
                   for n in reached) or any(
                    isinstance(node, ast.Attribute) and node.attr
                    == "program" for node in ast.walk(tree)):
                faults.append((str(where), "reaches a program entry"))
    return faults


def test_reference_and_yardstick_import_nothing_of_the_program():
    """The reference and the readers reach nothing of the program; the
    harness, the loops and the rest name the port nowhere and reach it
    only through a cell's program entry; no entry reaches the reference,
    so that it stays independent of what it judges."""
    assert (BENCH / "harness" / "program.py").exists()
    assert _isolation_faults(BENCH) == []


@pytest.mark.parametrize("planted, text, reason", [
    ("loops/leaky.py", f"from {PORT} import serve\n", "names the port"),
    ("harness/leaky.py", f"import {PORT}.ops\n", "names the port"),
    ("programs/peek.py", "from benchmark.reference import model\n",
     "an entry reaches the reference"),
    ("programs/peek_by_path.py",
     "from benchmark.harness import spec\n"
     "MODEL = spec.module('reference', 'model')\n",
     "an entry reaches the reference"),
    ("reference/peek.py", "from ..harness import program\n",
     "reaches a program entry"),
    ("metrics/peek.py",
     "def read(rec):\n    return rec.cell.program.launch_counts()\n",
     "reaches a program entry"),
])
def test_the_isolation_scan_bites(tmp_path, planted, text, reason):
    """A copy of the benchmark with one file planted that breaks the rule:
    the scan names that file and the reason, and nothing else."""
    import shutil

    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / planted).parent.mkdir(exist_ok=True)
    (bench / planted).write_text(text)
    assert _isolation_faults(bench) == [(planted, reason)]


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "brainmagick_tpu_torch_probe", sys)
    assert "brainmagick_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "brainmagick_tpu.probe", sys)
    assert cell.forbidden_modules() == ["brainmagick_tpu"]
    with pytest.raises(cell.ForbiddenModules):
        cell.check_modules()


def _command(cwd: Path, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "simpleconv_recipe.train", "--seed", str(2 ** 31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_command_exits_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(REPO, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_command_exits_with_the_benchmark_files_alone(tmp_path):
    """A folder with ``BENCHMARK.json`` and the benchmark's files only:
    the program is missing, and no result is printed."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
