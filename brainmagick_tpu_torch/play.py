"""Trained solvers by signature, their streaming test metrics, and the
notebook helpers.

Port of ``brainmagick_tpu/play.py``. A signature's solver is rebuilt from
the config delta its checkpoint stores (datasets, model, feature model)
with the best state loaded, or, for training, its whole state resumed.
``get_test_metrics`` runs each test recording's batches through
``Solver.forward_batch`` on the solver's device (split over the ranks of
a solver's group), and the metrics stream over the kept rows on the host.
``SentenceFeatures`` paints the features of a typed sentence (an
``EventTable`` of its words at fixed timings), ``attention_map`` gives the
merger's spatial attention over each recording's sensors (Table 1's
notebook), and ``predict`` the prediction's difference between zero
features and a sentence's, averaged over recordings, each through
``Solver.predict``.
"""

from __future__ import annotations

import json
import random
import typing as tp
from pathlib import Path

import numpy as np
import torch

from . import dataset as dset
from .cache import tagged
from .config import MainConfig
from .convert import JAX_CHECKPOINT, load_jax_checkpoint
from .events import EventTable
from .features import FeaturesBuilder
from .studies.api import INVALID_POSITION
from .utils import Frequency


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
    its state by ``Solver.restore``): for evaluation and serving its best
    weights, and with `training` its whole training state, Adam's moments
    included. An override that changes the signature raises, since the
    solver would restore another XP's folder."""
    folder = Path(out_dir) / "xps" / sig
    checkpoint = folder / tagged("checkpoint.pt")
    if checkpoint.exists():
        with open(checkpoint, "rb") as f:
            payload = torch.load(f, map_location="cpu", weights_only=True)
        delta = json.loads(payload["delta"])
    elif (folder / JAX_CHECKPOINT).exists():
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


class SentenceFeatures:
    """The features of a typed sentence, painted as the datasets paint a
    recording's: the first word at 1 s, each word 0.1 s a letter within
    [0.3, 0.8] s, 0.3 s between words, 1 s after the last; each word an
    event of sequence 12 in Dutch."""

    @classmethod
    def from_solver(cls, solver: tp.Any, **kwargs: tp.Any
                    ) -> "SentenceFeatures":
        dst = solver.args.dset
        return cls(dst.features, dict(dst.features_params),
                   sample_rate=dst.sample_rate, highpass=dst.highpass,
                   **kwargs)

    def __init__(self, features: tp.List[str], features_params: dict,
                 sample_rate: float, highpass: float = 0.0,
                 modality: str = "visual",
                 additional_time: float = 1.0) -> None:
        self._highpass = highpass
        self._sample_rate = Frequency(sample_rate)
        self._features = features
        self._features_params = features_params
        self._modality = modality
        self._additional_time = additional_time

    def _generate_events(self,
                         word_durations: tp.List[tp.Tuple[str, float]],
                         interword: float = 0.3) -> EventTable:
        time = 1.0
        events: tp.List[dict] = []
        sentence = " ".join(w for w, _ in word_durations)
        for k, (word, duration) in enumerate(word_durations):
            events.append(dict(
                kind="word", word=word, sequence_uid=12,
                modality=self._modality, start=time, duration=duration,
                word_index=k, word_sequence=sentence, language="nl"))
            time += duration + interword
        return EventTable.from_records(events).validate()

    def generate(self, word_durations: tp.List[tp.Tuple[str, float]],
                 interword: float = 0.3) -> np.ndarray:
        """The features [D, T] of words of the given (word, seconds)."""
        events = self._generate_events(word_durations, interword)
        duration = float(events["start"][-1] + events["duration"][-1]) \
            + self._additional_time
        builder = FeaturesBuilder(
            events, self._features, features_params=self._features_params,
            sample_rate=self._sample_rate)
        return builder(0, duration)[0]

    def __call__(self, sentence: str) -> np.ndarray:
        word_durations = [(word, max(0.3, min(0.8, 0.1 * len(word))))
                          for word in sentence.strip().split()]
        return self.generate(word_durations)

    def extract_basal_states(self, recording: tp.Any,
                             duration: float = 0.5) -> tp.Any:
        """The `duration` s of the recording before each sentence's first
        word, as a ``SegmentDataset``."""
        query = "kind=='word' & word_index==0"
        fact = dset.SegmentDataset.Factory(
            condition=query, tmin=-duration, tmax=0.0,
            highpass=self._highpass, sample_rate=self._sample_rate)
        ds = fact.apply(recording)
        assert ds is not None
        return ds


def attention_map(solver: tp.Any) -> tp.Tuple[np.ndarray, np.ndarray]:
    """The merger's spatial attention for every recording: (weights
    [R, O, C], positions [R, C, 2]), each virtual channel's softmax over
    the recording's sensors, those without a position left out; a
    per-subject merger's heads averaged over the subjects. Raises
    ValueError for a model without a merger."""
    na = solver.norm_arrays
    merger = getattr(solver.model, "merger", None)
    if merger is None or na.get("pos_emb") is None:
        raise ValueError("attention_map requires a SimpleConv with "
                         "merger=True")
    heads = merger.heads.detach().float().cpu()
    if heads.ndim == 3:             # per-subject heads: average over them
        heads = heads.mean(dim=0)
    table = na["pos_emb"].detach().float().cpu()             # [R, C, D]
    positions = na["rec_positions"].detach().float().cpu()   # [R, C, 2]
    scores = torch.einsum("rcd,od->roc", table, heads)
    invalid = (positions == INVALID_POSITION).all(dim=-1)
    scores = scores.masked_fill(invalid[:, None, :], float("-inf"))
    return torch.softmax(scores, dim=2).numpy(), positions.numpy()


def predict(solver: tp.Any, features: np.ndarray,
            subject_index: tp.Optional[int] = None,
            meg_init: bool = False) -> np.ndarray:
    """The prediction on zero features less the prediction on `features`
    [D, T], averaged over the solver's recordings (only `subject_index`'s
    when given), each on zero MEG, or with `meg_init` on the
    ``task.meg_init`` s before the recording's first sentence."""
    dst = solver.args.dset
    selections = [solver.args.selections[x] for x in dst.selections]
    recordings = list(dset._extract_recordings(
        selections, n_recordings=dst.n_recordings))
    indices = (list(range(len(recordings))) if subject_index is None
               else [subject_index])
    recordings = [recordings[k] for k in indices]
    outs = []
    base = 0 * features
    n_chan = solver.datasets.train[0].meg.shape[0]
    for recording in recordings:
        meg = np.zeros((n_chan, features.shape[1]), dtype=np.float32)
        if meg_init:
            builder = SentenceFeatures.from_solver(solver)
            basal = builder.extract_basal_states(
                recording, duration=solver.args.task.meg_init)
            chunk = basal[0].meg
            meg[:chunk.shape[0], :chunk.shape[1]] = chunk
        predictions = [
            solver.predict(features=f, meg=meg,
                           subject_index=recording.subject_index)
            for f in (features, base)]
        outs.append(predictions[1] - predictions[0])
    return sum(outs) / len(outs)
