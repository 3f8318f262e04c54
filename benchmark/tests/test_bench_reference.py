"""The frozen reference against the port at a tiny width on the CPU,
through the harness's own runs: in float32 the two agree to rounding on
every compared number, and in the recipe's bf16 they differ by bf16's
rounding."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import cell

SEED = 2 ** 32 + 17
#: float32 program against float32 reference: rounding only
FP32_TOL = {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-2,
            "estimate_gap": 1e-5, "probs_gap": 1e-5}


def _run(root, workload, trace=False):
    return cell.run(root, workload, SEED, 0.3, trace, torch.device("cpu"),
                    time.perf_counter(), root)


@pytest.mark.parametrize("workload", ["simpleconv_recipe.train",
                                      "deepmel_fp32.train",
                                      "simpleconv_recipe.retrieval"])
def test_fp32_program_matches_reference(tiny, workload):
    result = _run(tiny(fp32=True), workload)
    for name, c in result["checks"].items():
        assert c["value"] <= FP32_TOL[name], (name, c)
    assert result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("workload", ["simpleconv_recipe.train",
                                      "simpleconv_recipe.retrieval"])
def test_bf16_program_differs_by_rounding(tiny, workload):
    """The recipe's bf16 against the float32 reference: off by bf16's
    rounding (about 2^-8 a step), not by a wrong result."""
    result = _run(tiny(), workload, trace=True)
    assert all(c["value"] < 0.05 for c in result["checks"].values()), \
        result["checks"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
