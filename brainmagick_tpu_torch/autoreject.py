"""Artifact repair: bad sensors interpolated (not dropped) per epoch.

Port of ``brainmagick_tpu/autoreject.py``, in numpy on the host (the JAX
package runs it on the host too), after Jas et al. 2017:

  * per-channel rejection thresholds on the peak-to-peak amplitude,
    chosen by a cross-validated search over quantiles;
  * in each epoch, the channels past their threshold are bad, and the
    worst `n_interpolate` of them are replaced by an inverse-distance
    weighted mean of the good sensors over the 2D layout.
"""

from __future__ import annotations

import typing as tp

import numpy as np


def _ptp(epochs: np.ndarray) -> np.ndarray:
    """Peak-to-peak per epoch/channel: [N, C, T] -> [N, C]."""
    return epochs.max(axis=-1) - epochs.min(axis=-1)


class AutoRejectDrop:
    """Threshold fit and interpolating repair: fit on a sample of epochs,
    then transform whole epoch sets."""

    def __init__(self, n_interpolate: int = 4, consensus: float = 0.5,
                 quantiles: tp.Sequence[float] = (0.7, 0.8, 0.9, 0.95, 0.99),
                 n_folds: int = 5, drop: bool = False,
                 seed: int = 1234) -> None:
        self.n_interpolate = n_interpolate
        self.consensus = consensus
        self.quantiles = tuple(quantiles)
        self.n_folds = n_folds
        self.drop = drop
        self.seed = seed
        self.threshes_: tp.Optional[np.ndarray] = None  # [C]

    # -- fitting ---------------------------------------------------------------

    def fit(self, epochs: np.ndarray,
            positions: tp.Optional[np.ndarray] = None) -> "AutoRejectDrop":
        """Cross-validated per-channel P2P thresholds.

        For each candidate quantile, folds of epochs are scored by how
        well the mean of threshold-passing epochs predicts the median of
        the validation fold (the autoreject surrogate objective).
        """
        epochs = np.asarray(epochs, dtype=np.float32)
        n, n_chan, _ = epochs.shape
        ptp = _ptp(epochs)  # [N, C]
        rng = np.random.RandomState(self.seed)
        folds = rng.randint(0, self.n_folds, n)

        threshes = np.empty(n_chan, dtype=np.float32)
        for c in range(n_chan):
            best_err = np.inf
            best_thresh = np.quantile(ptp[:, c], self.quantiles[-1])
            for q in self.quantiles:
                thresh = np.quantile(ptp[:, c], q)
                errs = []
                for f in range(self.n_folds):
                    train = (folds != f) & (ptp[:, c] <= thresh)
                    val = folds == f
                    if train.sum() < 2 or val.sum() < 1:
                        continue
                    pred = epochs[train, c].mean(axis=0)
                    target = np.median(epochs[val, c], axis=0)
                    errs.append(np.sqrt(np.mean((pred - target) ** 2)))
                err = np.mean(errs) if errs else np.inf
                if err < best_err:
                    best_err = err
                    best_thresh = thresh
            threshes[c] = best_thresh
        self.threshes_ = threshes
        self.positions_ = positions
        return self

    # -- transform ---------------------------------------------------------------

    def get_reject_log(self, epochs: np.ndarray) -> np.ndarray:
        """[N, C] bool mask of bad channel entries."""
        assert self.threshes_ is not None, "run fit() first"
        return _ptp(np.asarray(epochs)) > self.threshes_[None, :]

    def transform(self, epochs: np.ndarray,
                  positions: tp.Optional[np.ndarray] = None,
                  return_log: bool = False):
        """Interpolate the worst bad channels of each epoch from good
        neighbors (inverse-distance weights over the 2D layout)."""
        epochs = np.array(epochs, dtype=np.float32)
        positions = positions if positions is not None else self.positions_
        assert positions is not None, "sensor positions required"
        bad = self.get_reject_log(epochs)
        ptp = _ptp(epochs)
        n, n_chan, _ = epochs.shape
        dist = np.linalg.norm(positions[:, None] - positions[None], axis=-1)
        np.fill_diagonal(dist, np.inf)
        for k in range(n):
            bad_idx = np.flatnonzero(bad[k])
            if not len(bad_idx):
                continue
            # interpolate the worst offenders first
            order = np.argsort(-ptp[k, bad_idx])
            bad_idx = bad_idx[order][:min(self.n_interpolate, len(bad_idx))]
            good = np.flatnonzero(~bad[k])
            if not len(good):
                continue
            for c in bad_idx:
                w = 1.0 / np.maximum(dist[c, good], 1e-3) ** 2
                w /= w.sum()
                epochs[k, c] = w @ epochs[k, good]
        if return_log:
            return epochs, bad
        return epochs

    def fit_transform(self, epochs: np.ndarray,
                      positions: tp.Optional[np.ndarray] = None
                      ) -> np.ndarray:
        return self.fit(epochs, positions).transform(epochs)

    def __call__(self, epochs: np.ndarray,
                 positions: tp.Optional[np.ndarray] = None) -> np.ndarray:
        return self.fit_transform(epochs, positions)
