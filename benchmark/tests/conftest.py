"""Shared fixtures of the benchmark's own tests (run from the repository
root: ``python -m pytest benchmark/tests``). They run on the CPU; a test
marked ``card`` needs a CUDA device and skips without one.

``tiny`` writes a copy of the benchmark into a temporary directory whose
configurations keep every option of the real ones at CPU-sized widths
(and with ``fp32=True`` the recipe's compute, estimate, wire and scores
in float32, so that the program and the reference agree to rounding)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: CPU-sized widths: the model section's and the program's overrides
TINY_MODEL = dict(sensors=20, recordings=3, subjects=3, merger_channels=12,
                  merger_pos_dim=32, initial_linear=12, hidden=16, depth=4,
                  batch_size=8, window_samples=61, offset_samples=6)
TINY_ARGS = {"simpleconv.hidden": 16, "simpleconv.depth": 4,
             "simpleconv.merger_channels": 12,
             "simpleconv.merger_pos_dim": 32,
             "simpleconv.initial_linear": 12, "optim.batch_size": 8,
             "task.offset_meg_ms": 50}
TINY_DEEPMEL = {"n_hidden_channels": 16, "n_hidden_layers": 4,
                "n_out_channels": 20, "kernel": 3, "stride": 1,
                "dilation_growth": 2, "dilation_period": 5,
                "batch_norm": True, "activation_on_last": False,
                "skip": True, "glu_context": 1, "glu": 2}
FP32_ARGS = {"simpleconv.dtype": None, "simpleconv.output_dtype": None,
             "clip.compute_dtype": None, "parallel.transfer_dtype": None,
             "parallel.assemble_dtype": None}
TINY_RETRIEVAL = dict(rows=8, candidates=32, warm_requests=1,
                      sample_requests=2)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def write_tiny(root: Path, fp32: bool = False) -> Path:
    """The benchmark's cells over tiny copies of its configurations, under
    `root` (``BENCHMARK.json``, ``configs/``, ``traffic/``, ``limits/``)."""
    bench = _read(REPO / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for entry in bench["configs"]:
        config = _read(REPO / entry["file"])
        config["model"].update(TINY_MODEL)
        overrides = dict(TINY_ARGS)
        if config["model"].get("deep_mel"):
            config["model"]["features"] = 10
            config["model"]["deep_mel"] = {"hidden": 16, "layers": 4,
                                           "out": 20}
            overrides["feature_model_params"] = TINY_DEEPMEL
        else:
            config["model"]["features"] = 24
        if fp32:
            overrides.update(FP32_ARGS)
            config.update(wire_dtype="float32", scores_dtype="float32")
        config["overrides"] = overrides
        entry["file"] = f"configs/{entry['name']}.json"
        (root / entry["file"]).write_text(json.dumps(config))
    for entry in bench["workloads"]:
        mix = _read(REPO / "benchmark" / "traffic" / f"{entry['traffic']}.json")
        if mix["loop"] == "retrieval":
            mix.update(TINY_RETRIEVAL)
        (root / "traffic" / f"{entry['traffic']}.json").write_text(
            json.dumps(mix))
        (root / "limits" / f"{entry['name']}.json").write_text(
            (REPO / "benchmark" / "limits" / f"{entry['name']}.json")
            .read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny(tmp_path):
    return lambda fp32=False: write_tiny(tmp_path / ("fp32" if fp32
                                                     else "bf16"), fp32)


@pytest.fixture
def card_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
