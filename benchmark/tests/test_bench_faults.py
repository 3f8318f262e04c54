"""The comparison that decides ``correct`` fails what it must: each fault
a cell can have, planted under the timed path of a whole run (the look
for a card skipped, the tiny configurations on the CPU in float32, where a
sound run reads rounding only), turns ``correct`` false; and the control,
the reference one precision below the configuration's, reads past at
least one of the cell's limits, each above the program's reading. On a
card, the control at the cells' own size (``benchmark.control``) does the
same."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import cell, spec
from brainmagick_tpu_torch import losses, serve

SEED = 977


def _run(root, workload):
    return cell.run(root, workload, SEED, 0.3, False, torch.device("cpu"),
                    time.perf_counter(), root)


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_loss(monkeypatch):
    original = losses.ClipLoss.loss_from_scores

    def half(scores, sample_weight=None, candidate_weight=None):
        weight = torch.ones(scores.shape[0], device=scores.device)
        weight[scores.shape[0] // 2:] = 0
        return original(scores, weight, candidate_weight)
    monkeypatch.setattr(losses.ClipLoss, "loss_from_scores",
                        staticmethod(half))


def _half_rows(monkeypatch):
    original = serve.Server.forward_batch

    def half(self, batch, pad_weight=None):
        estimate, *rest = original(self, batch, pad_weight)
        estimate = estimate.clone()
        estimate[estimate.shape[0] // 2:] = 0
        return (estimate, *rest)
    monkeypatch.setattr(serve.Server, "forward_batch", half)


def _altered(monkeypatch):
    original = serve.Server.probabilities

    def altered(self, estimates, candidates, inv_norms=None):
        probs = original(self, estimates, candidates, inv_norms).clone()
        probs[0] = probs[1]
        return probs
    monkeypatch.setattr(serve.Server, "probabilities", altered)


@pytest.mark.parametrize("workload, fault", [
    ("simpleconv_recipe.train", _unchanged),
    ("simpleconv_recipe.train", _half_loss),
    ("deepmel_fp32.train", _unchanged),
    ("deepmel_fp32.train", _half_loss),
    ("simpleconv_recipe.retrieval", _half_rows),
    ("simpleconv_recipe.retrieval", _altered),
])
def test_planted_fault_is_not_correct(tiny, monkeypatch, workload, fault):
    root = tiny(fp32=True)
    assert _run(root, workload)["correct"]
    fault(monkeypatch)
    result = _run(root, workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["simpleconv_recipe.train",
                                      "deepmel_fp32.train",
                                      "simpleconv_recipe.retrieval"])
def test_control_reads_past_a_limit(tiny, workload):
    root = tiny()
    c = spec.load_cell(root, workload, root)
    readings = dict(c.loop.readings(c, SEED, torch.device("cpu"),
                                    ["program", "control"]))
    past = [k for k, v in c.limits.items() if readings["control"][k] > v]
    assert past
    assert all(readings["program"][k] < readings["control"][k] for k in past)


@pytest.mark.parametrize("workload", ["simpleconv_recipe.train",
                                      "deepmel_fp32.train",
                                      "simpleconv_recipe.retrieval"])
def test_faults_around_the_reference_read_past_a_limit(tiny, workload):
    """Each fault the loop plants around the reference put in the
    program's place reads past at least one of the cell's limits."""
    root = tiny()
    c = spec.load_cell(root, workload, root)
    readings = dict(c.loop.readings(c, SEED, torch.device("cpu"),
                                    ["faults"]))
    assert len(readings) >= 2
    for name, numbers in readings.items():
        assert any(numbers[k] > v for k, v in c.limits.items()), \
            (name, numbers)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["simpleconv_recipe.train",
                                      "deepmel_fp32.train",
                                      "simpleconv_recipe.retrieval"])
def test_control_reads_past_a_limit_on_the_card(card_device, workload):
    c = spec.load_cell(spec.BENCH_DIR.parent, workload)
    for seed in (11, 12, 13):
        readings = dict(c.loop.readings(c, seed, card_device, ["control"]))
        assert any(readings["control"][k] > v for k, v in c.limits.items())
