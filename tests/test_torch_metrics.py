"""The port's streaming test metrics (brainmagick_tpu_torch.metrics) and
``play.get_test_metrics`` against the JAX package's on the same numpy
batches: each metric's per-recording value and its reduction."""

import types

import numpy as np
import pytest
import torch

from brainmagick_tpu import metrics as jmetrics
from brainmagick_tpu import play as jplay
from brainmagick_tpu_torch import metrics, play

B, F, T = 6, 5, 40


def _batches(seed, n=3, complex_values=False, categorical=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        left = rng.randn(B, F, T)
        right = 0.5 * left + rng.randn(B, F, T)
        if complex_values:
            left = left + 1j * rng.randn(B, F, T)
            right = right + 1j * rng.randn(B, F, T)
        if categorical:
            right = rng.randint(0, F, size=(B, 1, T)).astype(np.float64)
        mask = rng.rand(B, 1, T) > 0.3
        out.append((left, right, mask))
    return out


CASES = {
    "corr": (dict(), lambda m: m.OnlineCorrelation.get_constructor(
        slice(0, 4), slice(1, 5), name="corr")),
    "corr_complex": (dict(complex_values=True),
                     lambda m: m.OnlineCorrelation.get_constructor(
                         slice(None), slice(None), name="corr")),
    "l1": (dict(), lambda m: m.L1Reg.get_constructor(
        slice(0, 3), slice(2, 5), name="l1")),
    "l2": (dict(), lambda m: m.L2Reg.get_constructor(
        slice(None), slice(None), name="l2")),
    "acc": (dict(categorical=True), lambda m: m.ClassificationAcc
            .get_constructor(slice(None), slice(0, 1), name="acc")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_metrics_equal_the_jax_packages(case):
    kwargs, make = CASES[case]
    stats, jstats = [], []
    for seed in (0, 1):
        got, want = make(metrics)(), make(jmetrics)()
        for left, right, mask in _batches(seed, **kwargs):
            got.update(left, right, mask)
            want.update(left, right, mask)
        stats.append(got.get())
        jstats.append(want.get())
        np.testing.assert_allclose(stats[-1], jstats[-1], rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(type(got).reduce(stats),
                               type(want).reduce(jstats), rtol=1e-12)


class _Solver:
    """A duck-typed solver for both packages' get_test_metrics: two test
    recordings of host batches, a fixed "model" (a scaled copy of the
    features plus noise), and the given metric constructors."""

    def __init__(self, module, as_tensor):
        self.module = module
        self.as_tensor = as_tensor
        self.datasets = types.SimpleNamespace(test=types.SimpleNamespace(
            datasets=[_batches(seed, categorical=False) for seed in (3, 4)]))

    def get_metric_constructors(self):
        return [make(self.module) for name, (kw, make) in CASES.items()
                if not kw]

    def make_loader(self, dataset):
        return [(types.SimpleNamespace(left=left, right=right, mask=mask),
                 np.r_[np.ones(B - 1), 0.].astype(np.float32))
                for left, right, mask in dataset]

    def forward_batch(self, batch, pad_weight):
        keep = pad_weight > 0.5
        out = (batch.left, batch.right, batch.mask, keep)
        if self.as_tensor:
            return tuple(torch.from_numpy(np.asarray(x)) for x in out)
        return out


@pytest.mark.parametrize("trim_offset", [0, 7])
def test_get_test_metrics_equals_the_jax_packages(trim_offset):
    got = play.get_test_metrics(_Solver(metrics, True), trim_offset)
    want = jplay.get_test_metrics(_Solver(jmetrics, False), trim_offset)
    assert set(got) == set(want) == {"corr", "l1", "l2"}
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-12,
                                   err_msg=name)
    unreduced = play.get_test_metrics(_Solver(metrics, True), trim_offset,
                                      reduce=False)
    assert unreduced["l2"].shape[0] == 2
