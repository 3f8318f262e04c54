"""Normalization: per-recording robust MEG scaling, per-feature standard
scaling, category counts, and scale-based rejection.

Port of ``brainmagick_tpu/norm.py``. The scalers are fitted on the host in
numpy, from the same sampled epochs, and exported as dense arrays
(``BatchScaler.export_arrays``): per-recording [R, C] centre and scale for
the MEG, [F] for the features, which the solver applies on the device
(``ops.norm.normalize_clamp_peak`` gathers each sample's recording rows).
"""

from __future__ import annotations

import logging
import os
import random
import typing as tp
from collections import OrderedDict
from concurrent import futures

import numpy as np

from .features import Feature, FeaturesBuilder

logger = logging.getLogger(__name__)


def _as_nd(x: np.ndarray) -> np.ndarray:
    """[B, C, T] -> [B*T, C]."""
    return np.transpose(x, (0, 2, 1)).reshape(-1, x.shape[1])


class Scaler:
    def fit(self, X: np.ndarray, mask: np.ndarray) -> "Scaler":
        raise NotImplementedError

    def transform(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class RobustScaler(Scaler):
    """Per-channel quantile scaler: centre = median, scale = IQR (sorted
    column at index int(q * n)), a zero IQR (a padded channel) set to 1."""

    def __init__(self, lowq: float = 0.25, highq: float = 0.75,
                 subsample: float = 1.) -> None:
        self.lowq = lowq
        self.highq = highq
        self.subsample = subsample

    def fit(self, X: np.ndarray, mask: tp.Optional[np.ndarray] = None
            ) -> "RobustScaler":
        samples, _ = X.shape
        if self.subsample < 1.:
            rng = np.random.RandomState(1234)
            X = X[rng.rand(samples) < self.subsample]
        Xs = np.sort(X, axis=0)
        n = Xs.shape[0]
        idx = [min(int(q * n), n - 1) for q in (self.lowq, 0.5, self.highq)]
        low, med, high = Xs[idx[0]], Xs[idx[1]], Xs[idx[2]]
        self.center_ = med.astype(np.float32)
        scale = (high - low).astype(np.float32)
        scale[scale == 0] = 1
        self.scale_ = scale
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.center_) / self.scale_

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return X * self.scale_ + self.center_


class StandardScaler(Scaler):
    """Mean and standard deviation over the masked samples, per channel or
    shared by all channels."""

    def __init__(self, per_channel: bool = False) -> None:
        self.per_channel = per_channel

    def fit(self, X: np.ndarray, mask: np.ndarray) -> "StandardScaler":
        dim = X.shape[1]
        masked = X[np.broadcast_to(mask, X.shape)].reshape(-1, dim)
        if self.per_channel:
            self.center_ = masked.mean(axis=0)
            self.scale_ = masked.std(axis=0)
        else:
            self.center_ = np.full(dim, masked.mean(), dtype=np.float32)
            self.scale_ = np.full(dim, masked.std(), dtype=np.float32)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.center_) / self.scale_

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return X * self.scale_ + self.center_


class NoOpScaler(Scaler):
    def fit(self, X: np.ndarray, mask: np.ndarray) -> "NoOpScaler":
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return X

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return X


class NoOpCategoryCountScaler(NoOpScaler):
    """The identity, which also counts the categories of the masked
    samples."""

    def __init__(self, cardinality: int) -> None:
        self.cardinality = cardinality

    def fit(self, X: np.ndarray, mask: np.ndarray
            ) -> "NoOpCategoryCountScaler":
        vals = X[np.broadcast_to(mask, X.shape)]
        assert np.all(vals == vals.astype(int)) and vals.min() >= 0 \
            and vals.max() < self.cardinality
        self.categories_count_ = np.bincount(
            vals.astype(int), minlength=self.cardinality).astype(np.float32)
        return self


class BatchScaler:
    """One MEG scaler per recording and one scaler per feature, fitted on
    sampled epochs and exported as dense arrays."""

    def __init__(self, features_builder: FeaturesBuilder,
                 n_samples_per_recording: int = 200,
                 per_channel: bool = False,
                 n_samples_features: tp.Optional[int] = None) -> None:
        self.n_samples_per_recording = n_samples_per_recording
        self.n_samples_features = n_samples_features
        self.per_channel = per_channel
        self.features_builder = features_builder
        self.meg_scalers: tp.Dict[int, Scaler] = {}
        self.feature_scalers: "OrderedDict[str, Scaler]" = OrderedDict()
        for name, feature in features_builder.items():
            self.feature_scalers[name] = self._make_feature_scaler(feature)

    def _make_feature_scaler(self, feature: Feature) -> Scaler:
        if feature.normalizable:
            return StandardScaler(self.per_channel)
        if feature.categorical:
            return NoOpCategoryCountScaler(feature.cardinality)
        return NoOpScaler()

    def fit(self, datasets: tp.Sequence[tp.Any],
            rng_seed: int = 1234) -> "BatchScaler":
        """Fit on up to ``n_samples_per_recording`` epochs of each
        per-recording dataset (``RandomState(rng_seed).permutation`` per
        recording), the feature scalers on the epochs of recordings taken
        in a ``random.Random(1234)`` order until ``n_samples_features``
        are in. The recordings are read in a thread pool; the result does
        not depend on its order."""
        def fit_one(dset):
            n = min(len(dset), self.n_samples_per_recording)
            rng = np.random.RandomState(rng_seed)
            idx = rng.permutation(len(dset))[:n]
            items = [dset[int(i)] for i in idx]
            scaler = RobustScaler()
            scaler.fit(_as_nd(np.stack([it.meg for it in items])))
            return (dset.recording.recording_index, scaler,
                    np.stack([it.features for it in items]),
                    np.stack([it.features_mask for it in items]))

        workers = min(8, os.cpu_count() or 1, max(1, len(datasets)))
        if workers > 1:
            with futures.ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(fit_one, datasets))
        else:
            results = [fit_one(d) for d in datasets]
        all_features: tp.List[np.ndarray] = []
        all_mask: tp.List[np.ndarray] = []
        for rec_index, scaler, feats, masks in results:
            assert rec_index not in self.meg_scalers
            self.meg_scalers[rec_index] = scaler
            all_features.append(feats)
            all_mask.append(masks)

        if self.n_samples_features is not None:
            order = list(range(len(all_features)))
            random.Random(1234).shuffle(order)
            all_features = [all_features[i] for i in order]
            all_mask = [all_mask[i] for i in order]
            remaining = self.n_samples_features
            for k, f in enumerate(all_features):
                remaining -= len(f)
                if remaining <= 0:
                    all_features = all_features[:k + 1]
                    all_mask = all_mask[:k + 1]
                    break

        features = _as_nd(np.concatenate(all_features))
        mask = _as_nd(np.concatenate(all_mask))
        logger.info("features collected for norm: %r", features.shape)
        for name, scaler in self.feature_scalers.items():
            scaler.fit(features[:, self.features_builder.get_slice(name)],
                       mask)
            if isinstance(scaler, StandardScaler) \
                    and not (scaler.scale_ > 0).all():
                raise ValueError(f"Feature {name} could not be normalized "
                                 f"(constant values).")
        return self

    def export_arrays(self, n_recordings: int, n_channels: int
                      ) -> tp.Dict[str, np.ndarray]:
        """The MEG statistics as [R, C] ``meg_center``/``meg_scale`` (the
        identity for a recording without a scaler) and the features' as
        [F] ``feat_center``/``feat_scale``."""
        meg_center = np.zeros((n_recordings, n_channels), dtype=np.float32)
        meg_scale = np.ones((n_recordings, n_channels), dtype=np.float32)
        for rec, scaler in self.meg_scalers.items():
            c = np.asarray(scaler.center_)
            s = np.asarray(scaler.scale_)
            meg_center[rec, :len(c)] = c
            meg_scale[rec, :len(s)] = s
        dim = self.features_builder.dimension
        feat_center = np.zeros(dim, dtype=np.float32)
        feat_scale = np.ones(dim, dtype=np.float32)
        for name, scaler in self.feature_scalers.items():
            if isinstance(scaler, StandardScaler):
                sl = self.features_builder.get_slice(name)
                feat_center[sl] = scaler.center_
                feat_scale[sl] = scaler.scale_
        return dict(meg_center=meg_center, meg_scale=meg_scale,
                    feat_center=feat_center, feat_scale=feat_scale)

    def transform(self, batch: tp.Any) -> tp.Any:
        return self._transform(batch, inverse=False)

    def inverse_transform(self, batch: tp.Any) -> tp.Any:
        return self._transform(batch, inverse=True)

    def _transform(self, batch: tp.Any, inverse: bool) -> tp.Any:
        meg = np.asarray(batch.meg)
        features = np.asarray(batch.features)
        if features.shape[1] != self.features_builder.dimension:
            raise ValueError(
                f"Invalid feature dim {features.shape[1]}, expected "
                f"{self.features_builder.dimension}")
        out_meg = np.empty_like(meg)
        for k, rec in enumerate(np.asarray(batch.recording_index)):
            scaler = self.meg_scalers[int(rec)]
            fn = scaler.inverse_transform if inverse else scaler.transform
            out_meg[k] = fn(meg[k].T).T
        out_feat = np.empty_like(features)
        for name, scaler in self.feature_scalers.items():
            sl = self.features_builder.get_slice(name)
            fn = scaler.inverse_transform if inverse else scaler.transform
            block = features[:, sl]
            nd = np.transpose(block, (0, 2, 1)).reshape(-1, block.shape[1])
            out = fn(nd).reshape(block.shape[0], block.shape[2], -1)
            out_feat[:, sl] = np.transpose(out, (0, 2, 1))
        return batch.replace(meg=out_meg, features=out_feat)

    def get_categorical_feature_weights(self, feature_name: str
                                        ) -> np.ndarray:
        """A categorical feature's class weights for the cross-entropy:
        1 / sqrt(p) of each class's frequency p among the counted samples,
        scaled so that their mean under p is 1; 0 for a class never seen."""
        scaler = self.feature_scalers[feature_name]
        assert isinstance(scaler, NoOpCategoryCountScaler)
        probs = scaler.categories_count_ / scaler.categories_count_.sum()
        with np.errstate(divide="ignore"):
            weights = 1 / np.sqrt(probs)
        weights[probs == 0] = 0.
        weights /= np.sqrt(probs).sum()
        return weights.astype(np.float32)


class ScaleReject:
    """Normalize a host batch, clamp it to ±`limit` when `clip`, and mark
    the rows whose peak exceeds `limit` (or whose feature mask is empty,
    with `exclude_empty_features`). ``__call__`` returns (batch, keep):
    the batch keeps its size and the caller masks the loss."""

    def __init__(self, scaler: BatchScaler, limit: float = 16,
                 exclude_empty_features: bool = False,
                 clip: bool = False) -> None:
        self.scaler = scaler
        self.limit = limit
        self.clip = clip
        self.exclude_empty_features = exclude_empty_features
        self._rejection_count = 0
        self._count = 0

    def __call__(self, batch: tp.Any) -> tp.Tuple[tp.Any, np.ndarray]:
        batch = self.scaler.transform(batch)
        self._count += len(batch.meg)
        meg = batch.meg
        if self.clip:
            meg = np.clip(meg, -self.limit, self.limit)
            batch = batch.replace(meg=meg)
        peak = np.abs(meg).reshape(len(meg), -1).max(axis=-1)
        reject = peak > self.limit
        if self.exclude_empty_features:
            empty = batch.features_mask.reshape(
                len(batch.features_mask), -1).sum(-1) == 0
            reject |= empty
        self._rejection_count += int(reject.sum())
        return batch, ~reject

    @property
    def rejection_rate(self) -> float:
        return self._rejection_count / max(self._count, 1)
