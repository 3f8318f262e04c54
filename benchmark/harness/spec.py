"""The benchmark's data and code, found by name: ``BENCHMARK.json`` at the
root, each configuration's file, each traffic mix's file
(``benchmark/traffic/<traffic>.json``), the loop its ``loop`` key names
(``benchmark/loops/<loop>.py``), the plain reference its configuration's
``reference`` key names (``benchmark/reference/<reference>.py``), the
program entry its configuration's ``program`` key names
(``benchmark/programs/<program>.py``; ``harness/program.py`` for a
configuration without the key), each cell's limits
(``benchmark/limits/<workload>.json``) and each per-layer metric's reader
(``benchmark/metrics/<quantity>.py``, the metric's name up to its first
dot). A cell, a mix, a loop, a reference, a program entry or a metric is
added by adding files and entries; nothing here names one.

A program entry builds the program's objects for the loops that use it
and loads the run's seeded weights into them (``harness/program.load``).
It is loaded from its path, so an entry that starts processes gives them
a target importable by name: the port's own entry point, or a
``python3 -m`` command."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import typing as tp
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tp.List[dict]
    per_layer: tp.List[dict]
    #: the mix's loop (``loops/<loop>.py``): ``window``, ``readings`` and
    #: ``unit_flops`` of this kind of traffic
    loop: tp.Any
    #: the configuration's plain reference (``reference/<reference>.py``)
    reference: tp.Any
    #: the configuration's program entry (``program_entry``)
    program: tp.Any
    #: the cards the cell asks for
    chips: int


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return _read(Path(root) / "BENCHMARK.json")


def find(kind: str, filename: str, bench_dir: tp.Optional[Path] = None
         ) -> Path:
    """``<bench_dir>/<kind>/<filename>``, else the benchmark folder's."""
    for base in (bench_dir, BENCH_DIR):
        if base is not None and (Path(base) / kind / filename).exists():
            return Path(base) / kind / filename
    raise FileNotFoundError(f"no {kind}/{filename} under {bench_dir} or "
                            f"{BENCH_DIR}")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: tp.Union[str, Path], workload: str,
              bench_dir: tp.Optional[Path] = None) -> Cell:
    """The cell `workload` of ``root/BENCHMARK.json``: its configuration
    (the file its entry names, relative to `root`), its mix and its limits
    (under `bench_dir`, else the benchmark's folder), and the
    end-to-end and per-layer metrics it reports."""
    root = Path(root)
    spec = benchmark(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}"
                       f"; known: {sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = dict(_read(root / configs[entry["config"]]["file"]))
    config["name"] = entry["config"]
    traffic = _read(find("traffic", f"{entry['traffic']}.json", bench_dir))
    limits = _read(find("limits", f"{workload}.json", bench_dir))
    end_to_end = [m for m in spec["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload) and m["moves"] in moved]
    return Cell(workload, config, traffic, limits, end_to_end, per_layer,
                module("loops", traffic["loop"], bench_dir),
                module("reference", config["reference"], bench_dir),
                program_entry(config, bench_dir), entry["chips"])


def program_entry(config: dict, bench_dir: tp.Optional[Path] = None
                  ) -> tp.Any:
    """The module that builds the program for `config`:
    ``programs/<program>.py`` where the configuration has a ``program``
    key, else ``harness/program.py``."""
    if "program" in config:
        return module("programs", config["program"], bench_dir)
    from . import program
    return program


_MODULES: tp.Dict[Path, tp.Any] = {}


def module(kind: str, name: str, bench_dir: tp.Optional[Path] = None
           ) -> tp.Any:
    """The module ``<kind>/<name>.py`` (``find``), loaded from its path
    once a process."""
    path = find(kind, f"{name}.py", bench_dir).resolve()
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{name}_{len(_MODULES)}", path)
        loaded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded)
        _MODULES[path] = loaded
    return _MODULES[path]


def reader(name: str, bench_dir: tp.Optional[Path] = None) -> tp.Any:
    """The module that reads the per-layer metric `name`:
    ``metrics/<quantity>.py`` for the part of the name before its first
    dot."""
    return module("metrics", name.split(".", 1)[0], bench_dir)
