"""Trained solvers by signature, and their streaming test metrics.

Port of ``get_solver_from_sig`` and ``get_test_metrics`` of
``brainmagick_tpu/play.py``. A signature's solver is rebuilt from the
config delta its port checkpoint stores (datasets, model, feature model)
with the best state loaded. ``get_test_metrics`` runs each test
recording's batches through ``Solver.forward_batch`` on the solver's
device (split over the ranks of a solver's group), and the metrics
stream over the kept rows on the host.
"""

from __future__ import annotations

import json
import random
import typing as tp
from pathlib import Path

import numpy as np
import torch

from .cache import tagged
from .config import MainConfig
from .convert import JAX_CHECKPOINT, load_jax_checkpoint


def get_solver_from_args(args: tp.Any, training: bool = False,
                         group: tp.Any = None) -> tp.Any:
    from .train import get_solver
    return get_solver(args, training=training, group=group)


def _apply_delta(args: MainConfig, delta: tp.Dict[str, tp.Any]
                 ) -> MainConfig:
    from .train import parse_overrides
    return parse_overrides([f"{k}={v!r}" for k, v in delta.items()], args)


def get_solver_from_sig(sig: str, out_dir: str = "./outputs",
                        override_args: tp.Optional[dict] = None,
                        training: bool = False, group: tp.Any = None
                        ) -> tp.Any:
    """The solver of the XP `sig` in `out_dir`: its config rebuilt from
    the delta stored in ``xps/<sig>/checkpoint-torch.pt`` (a JSON string,
    where the JAX package's is a dict), `override_args` ({dotted key:
    value}) on top, then ``train.get_solver``, which restores the
    checkpoint and, without `training`, loads the best state; with `group`
    (``train.join_launcher``) a rank of it. An XP folder with the JAX
    package's ``checkpoint.pkl`` only is read without jax (its delta here,
    its weights by ``Solver.restore``), for evaluation and serving: with
    `training` it raises NotImplementedError. An override that changes the
    signature raises, since the solver would restore another XP's
    folder."""
    folder = Path(out_dir) / "xps" / sig
    checkpoint = folder / tagged("checkpoint.pt")
    if checkpoint.exists():
        with open(checkpoint, "rb") as f:
            payload = torch.load(f, map_location="cpu", weights_only=True)
        delta = json.loads(payload["delta"])
    elif (folder / JAX_CHECKPOINT).exists():
        if training:
            raise NotImplementedError(
                f"{folder} holds the JAX package's {JAX_CHECKPOINT} only: "
                f"resuming its training (its optax Adam moments) is not "
                f"ported; it loads for evaluation and serving")
        delta = dict(load_jax_checkpoint(folder / JAX_CHECKPOINT)["delta"])
    else:
        raise FileNotFoundError(f"No checkpoint at {checkpoint}")
    delta.update(override_args or {})
    args = _apply_delta(MainConfig(out_dir=out_dir), delta)
    args.out_dir = out_dir
    if args.sig != sig:
        raise ValueError(f"the overrides {override_args} change the "
                         f"signature {sig} to {args.sig}")
    return get_solver_from_args(args, training=training, group=group)


def get_test_metrics(solver: tp.Any, trim_offset: int = 0,
                     metrics_constructor: tp.Optional[tp.List] = None,
                     reduce: bool = True,
                     datasets: tp.Optional[tp.List] = None
                     ) -> tp.Dict[str, tp.Any]:
    """{metric name: value} over the test recordings (each recording's
    metric, then ``reduce`` over the recordings when `reduce`), the
    samples before `trim_offset` left out. As a rank of a group, every
    rank takes the recordings in rank 0's order, so that each batch's
    forward (split over the ranks) meets the same batch on every rank, and
    gets the one-card metrics (on one host the JAX package's average over
    processes has nothing to average)."""
    test_datasets = datasets or solver.datasets.test.datasets
    order = list(range(len(test_datasets)))
    random.shuffle(order)
    group = getattr(solver, "group", None)
    if group is not None:
        order = group.broadcast_object(order)
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
