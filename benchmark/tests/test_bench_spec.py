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


#: the outside twins of the program's spans, retired
TWINS = {"host_dispatch_ms.train", "forward_ms.retrieval",
         "scoring_ms.retrieval"}
TRAIN_LAYERS = {"conv_device_ms.train", "normalize_clamp_peak_roofline.train",
                "mfu.train", "device_idle_pct.train", "step_host_ms.train",
                "forward_host_ms.train", "backward_host_ms.train",
                "optimizer_host_ms.train", "forward_device_ms.train",
                "backward_device_ms.train", "launches.train",
                "host_syncs.train"}
#: each cell's end-to-end and per-layer metrics when the program entries
#: became files of their own, the twins left out
CELLS = {
    "simpleconv_recipe.train": ({"train_samples_per_s", "setup_s"},
                                TRAIN_LAYERS),
    "deepmel_fp32.train": ({"train_samples_per_s", "setup_s"},
                           TRAIN_LAYERS),
    "simpleconv_recipe.retrieval": (
        {"eval_windows_per_s", "eval_request_p95_ms", "setup_s"},
        {"normalize_clamp_peak_roofline.retrieval",
         "nt_matmul_roofline.retrieval", "mfu.retrieval",
         "device_idle_pct.retrieval", "forward_host_ms.retrieval",
         "scoring_host_ms.retrieval", "forward_device_ms.retrieval",
         "scoring_device_ms.retrieval", "inv_norms_device_ms.retrieval",
         "launches.retrieval", "host_syncs.retrieval",
         "inv_norms_roofline.retrieval"}),
}


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_cells_load_as_before(bench, workload):
    """Each cell's configuration, mix, loop, reference and limits are the
    files its entries name, its program entry is ``harness/program.py``
    (its configuration names none), and it reports at least the metrics
    it did, less the retired twins."""
    from benchmark.harness import program

    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    files = {c["name"]: c["file"] for c in bench["configs"]}
    c = spec.load_cell(REPO, workload)
    config = json.loads((REPO / files[entry["config"]]).read_text())
    assert "program" not in config
    assert c.config == dict(config, name=entry["config"])
    bench_dir = REPO / "benchmark"
    assert c.traffic == json.loads(
        (bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
    assert c.limits == json.loads(
        (bench_dir / "limits" / f"{workload}.json").read_text())
    assert Path(c.loop.__file__) == bench_dir / "loops" / \
        f"{c.traffic['loop']}.py"
    assert Path(c.reference.__file__) == bench_dir / "reference" / \
        f"{config['reference']}.py"
    assert c.program is program and c.chips == entry["chips"] == 1
    end_to_end, per_layer = CELLS[workload]
    assert {m["name"] for m in c.end_to_end} >= end_to_end
    assert {m["name"] for m in c.per_layer} >= per_layer
    assert not TWINS & {m["name"] for m in bench["per_layer"]}


#: a program entry of its own: the program's server built and loaded by
#: the shared checking loader, and counted
TOY_ENTRY = '''"""A toy program entry: the port's server, counted."""

from benchmark.harness.program import launch_counts, load, port_args  # noqa

BUILT = []


def server(config, params, stats, norm, device):
    from brainmagick_tpu_torch.serve import Server

    m = config["model"]
    out = Server(port_args(config), m["sensors"], m["features"],
                 m["subjects"], None, None, norm, device)
    load(out.model, params, stats)
    BUILT.append(out)
    return out
'''


def test_the_checking_loader_refuses_what_does_not_fit():
    """``harness.program.load``, which every program entry applies: every
    parameter and running statistic given, none unknown, shapes equal."""
    from benchmark.harness import program

    net = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    params = {k: torch.randn(v.shape) for k, v in net.named_parameters()}
    stats = {"1.running_mean": torch.randn(2), "1.running_var": torch.rand(2)}
    program.load(net, params, stats)
    assert torch.equal(net[0].weight, params["0.weight"])
    assert torch.equal(net[1].running_var, stats["1.running_var"])
    with pytest.raises(KeyError, match="missing"):
        program.load(net, {k: v for k, v in params.items()
                           if k != "0.bias"}, stats)
    with pytest.raises(KeyError, match="unknown"):
        program.load(net, dict(params, extra=torch.zeros(1)), stats)
    with pytest.raises(ValueError, match="0.weight"):
        program.load(net, dict(params, **{"0.weight": torch.zeros(3, 2)}),
                     stats)


@pytest.mark.parametrize("new_code", [False, True])
def test_a_cell_added_as_data_only_runs(tiny, new_code):
    """A new configuration file and a new mix file, and entries naming
    them, in another folder: the harness finds and runs them with no new
    code. With `new_code` the mix names a new loop and the configuration
    a new reference and a program entry (``"program": "toy"``), each a
    file of its own in that folder, found by name with no file of the
    benchmark edited; the run builds its program through that entry.
    Without, the configuration names no entry and gets
    ``harness/program.py``."""
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
        (root / "programs").mkdir()
        (root / "programs" / "toy.py").write_text(TOY_ENTRY)
        config["program"] = "toy"
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
    assert Path(c.program.__file__) == (
        root / "programs" / "toy.py" if new_code
        else spec.BENCH_DIR / "harness" / "program.py")
    result = cell.run(root, "shallow.small_bank", 2 ** 33 + 5, 0.3, True,
                      torch.device("cpu"), time.perf_counter(), root)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert "mfu.retrieval" in result["metrics"]
    if new_code:
        assert len(c.program.BUILT) == 1
