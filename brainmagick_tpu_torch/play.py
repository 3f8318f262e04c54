"""Streaming test metrics of a trained solver.

Port of ``get_test_metrics`` of ``brainmagick_tpu/play.py``: each test
recording's batches go through ``Solver.forward_batch`` on the solver's
device, and the metrics stream over the kept rows on the host.
"""

from __future__ import annotations

import random
import typing as tp

import numpy as np


def get_test_metrics(solver: tp.Any, trim_offset: int = 0,
                     metrics_constructor: tp.Optional[tp.List] = None,
                     reduce: bool = True,
                     datasets: tp.Optional[tp.List] = None
                     ) -> tp.Dict[str, tp.Any]:
    """{metric name: value} over the test recordings (each recording's
    metric, then ``reduce`` over the recordings when `reduce`), the
    samples before `trim_offset` left out."""
    test_datasets = datasets or solver.datasets.test.datasets
    order = list(range(len(test_datasets)))
    random.shuffle(order)
    if metrics_constructor is None:
        metrics_constructor = solver.get_metric_constructors()
    results: tp.Dict[str, tp.List[tp.Any]] = {
        ctor().name: [None] * len(test_datasets)
        for ctor in metrics_constructor}

    for dset_index in order:
        loader = solver.make_loader(test_datasets[dset_index])
        metrics = [ctor() for ctor in metrics_constructor]
        for batch, pad_weight in loader:
            estimate, gt, features_mask, keep = solver.forward_batch(
                batch, pad_weight)
            if not keep.any():
                continue
            estimate = estimate[keep][..., trim_offset:].double().cpu()
            gt = gt[keep][..., trim_offset:].double().cpu()
            features_mask = features_mask[keep][..., trim_offset:].cpu()
            for metric in metrics:
                metric.update(estimate.numpy(), gt.numpy(),
                              features_mask.numpy())
        for metric in metrics:
            results[metric.name][dset_index] = metric.get()

    for ctor in metrics_constructor:
        metric = ctor()
        vals = results[metric.name]
        assert all(v is not None for v in vals)
        results[metric.name] = metric.reduce(vals) if reduce \
            else np.stack(vals)
    return results
