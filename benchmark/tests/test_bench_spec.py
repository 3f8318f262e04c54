"""``BENCHMARK.json``'s shape (keys, names, units, sizes), and every file it
names found by name; a cell added as data only is picked up and runs."""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import cell, spec
from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == TOP
    assert 1 <= bench["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(map(_line, bench["command"]))
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        c = spec.load_cell(REPO, w["name"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer, w["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for name in m.get("workloads", []):
            assert name in e2e[m["moves"]].get("workloads", [name])


def test_named_files_are_found(bench):
    for c in bench["configs"]:
        config = json.loads((REPO / c["file"]).read_text())
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        c = spec.load_cell(REPO, w["name"])
        assert all(callable(getattr(c.loop, f)) for f in
                   ("window", "readings", "unit_flops"))
        assert callable(c.reference.train_steps)
        assert set(c.limits) and all(v > 0 for v in c.limits.values())
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("new_code", [False, True])
def test_a_cell_added_as_data_only_runs(tiny, new_code):
    """A new configuration file and a new mix file, and entries naming
    them, in another folder: the harness finds and runs them with no new
    code. With `new_code` the mix names a new loop and the configuration
    a new reference, each a file of its own in that folder, found by name
    with no file of the benchmark edited."""
    root = tiny(fp32=True)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = next(c for c in bench["configs"]
                if not json.loads((root / c["file"]).read_text())["model"]
                .get("deep_mel"))
    config = json.loads((root / base["file"]).read_text())
    config["model"]["depth"] = 2
    config["overrides"]["simpleconv.depth"] = 2
    mix = json.loads((root / "traffic" / "retrieval.json").read_text())
    mix.update(candidates=16, rows=4)
    if new_code:
        for kind, name, new in (("loops", mix["loop"], "requests_b"),
                                ("reference", config["reference"],
                                 "model_b")):
            (root / kind).mkdir(exist_ok=True)
            shutil.copy(spec.BENCH_DIR / kind / f"{name}.py",
                        root / kind / f"{new}.py")
        mix["loop"], config["reference"] = "requests_b", "model_b"
    (root / "configs" / "shallow.json").write_text(json.dumps(config))
    (root / "traffic" / "small_bank.json").write_text(json.dumps(mix))
    bench["configs"].append(dict(base, name="shallow",
                                 file="configs/shallow.json"))
    bench["workloads"].append({"name": "shallow.small_bank",
                               "config": "shallow", "traffic": "small_bank",
                               "chips": 1, "why": "a data-only cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "eval_windows_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append("shallow.small_bank")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "limits" / "shallow.small_bank.json").write_text(
        json.dumps({"estimate_gap": 1e-4, "probs_gap": 1e-4}))
    c = spec.load_cell(root, "shallow.small_bank", root)
    assert c.config["model"]["depth"] == 2 and c.traffic["candidates"] == 16
    home = root if new_code else spec.BENCH_DIR
    assert Path(c.loop.__file__).parent == home / "loops"
    assert Path(c.reference.__file__).parent == home / "reference"
    result = cell.run(root, "shallow.small_bank", 2 ** 33 + 5, 0.3, True,
                      torch.device("cpu"), time.perf_counter(), root)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert "mfu.retrieval" in result["metrics"]
