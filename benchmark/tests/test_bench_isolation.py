"""What the harness may import and where it may run: no file of the
benchmark imports ``jax``, ``jaxlib``, ``flax``, ``optax`` or the JAX
package (top-level names compared whole, so the port's
``brainmagick_tpu_torch`` is allowed); the reference imports nothing of
the program; a run refuses a process holding one of them; and the
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


def test_reference_and_yardstick_import_nothing_of_the_program():
    """The reference and the readers import nothing of the program; the
    harness and the loops reach it only through ``harness/program.py``."""
    for sub in ("reference", "metrics"):
        for path in (BENCH / sub).rglob("*.py"):
            assert "brainmagick_tpu_torch" not in _imports(path), path
    for path in [*(BENCH / "harness").glob("*.py"),
                 *(BENCH / "loops").glob("*.py")]:
        if path.name != "program.py":
            text = path.read_text()
            assert "brainmagick_tpu_torch" not in text, path


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
