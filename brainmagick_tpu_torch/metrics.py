"""Streaming test metrics over feature slices, on the host in numpy.

Port of ``brainmagick_tpu/metrics.py``: Pearson correlation from running
sums (complex-capable), accumulated L1 and L2 errors, and argmax accuracy
with the masked positions never counted correct.
"""

from __future__ import annotations

import typing as tp
from functools import partial

import numpy as np


class TestMetric:
    def __init__(self, left_slice: slice, right_slice: slice,
                 name: str = "metric"):
        self.name = name
        self.left_slice = left_slice
        self.right_slice = right_slice

    @classmethod
    def get_constructor(cls, *args: tp.Any, **kwargs: tp.Any
                        ) -> tp.Callable[..., "TestMetric"]:
        return partial(cls, *args, **kwargs)

    def update(self, left: np.ndarray, right: np.ndarray,
               mask: np.ndarray) -> "TestMetric":
        raise NotImplementedError

    def get(self) -> np.ndarray:
        raise NotImplementedError

    @classmethod
    def reduce(cls, stats: tp.List[np.ndarray]) -> float:
        return float(np.mean([np.mean(s) for s in stats]))


class OnlineCorrelation(TestMetric):
    """Streaming Pearson correlation along `dim`, extended to complex as
    Re[conj(x)^T y] / (|x| |y|) for centred variables."""

    def __init__(self, left_slice: slice, right_slice: slice,
                 name: str = "correlation", dim: int = 0,
                 tol: float = 1e-8):
        super().__init__(left_slice, right_slice, name)
        self.dim = dim
        self.tol = tol
        self._count: tp.Optional[np.ndarray] = None

    def update(self, left: np.ndarray, right: np.ndarray,
               mask: np.ndarray) -> "OnlineCorrelation":
        left = np.asarray(left)[:, self.left_slice]
        right = np.asarray(right)[:, self.right_slice]
        mask = np.asarray(mask)
        dim = self.dim
        if self._count is None:
            ref = np.take(left, 0, axis=dim)
            self._sum_dot = np.zeros_like(ref)
            self._sum_left = np.zeros_like(ref)
            self._sum_right = np.zeros_like(ref)
            self._sum_left_sq = np.zeros_like(ref.real)
            self._sum_right_sq = np.zeros_like(ref.real)
            self._count = np.zeros_like(ref.real)
        self._sum_dot += (np.conj(left) * right * mask).sum(dim)
        self._sum_left += (left * mask).sum(dim)
        self._sum_right += (right * mask).sum(dim)
        self._sum_left_sq += (np.abs(left * mask) ** 2).sum(dim)
        self._sum_right_sq += (np.abs(right * mask) ** 2).sum(dim)
        self._count += np.broadcast_to(mask, left.shape).sum(dim)
        return self

    def get(self) -> np.ndarray:
        def norm_centered(s, sq):
            norm_sq = sq - np.abs(s) ** 2 / self._count
            if norm_sq.min() < -self.tol:
                raise ValueError(
                    f"Numerical instability in correlation: {norm_sq.min()}")
            return np.sqrt(np.clip(norm_sq, 0, None))

        norm_left = norm_centered(self._sum_left, self._sum_left_sq)
        norm_right = norm_centered(self._sum_right, self._sum_right_sq)
        dot = self._sum_dot - np.conj(self._sum_left) * self._sum_right \
            / self._count
        corr = np.real(dot) / np.clip(norm_left * norm_right, self.tol, None)
        assert not np.isnan(corr).any(), "correlation contains NaNs"
        return corr


class AccumulativeMetric(TestMetric):
    """Base for metrics that sum a per-position statistic and divide by
    the mask count."""

    def __init__(self, left_slice: slice, right_slice: slice,
                 name: str = "N/A", dim: int = 0):
        super().__init__(left_slice, right_slice, name)
        self.dim = dim
        self._count: tp.Optional[np.ndarray] = None

    def update(self, left: np.ndarray, right: np.ndarray,
               mask: np.ndarray) -> "AccumulativeMetric":
        left = np.asarray(left)[:, self.left_slice]
        right = np.asarray(right)[:, self.right_slice]
        mask = np.asarray(mask)
        if self._count is None:
            ref = np.take(right, 0, axis=self.dim)
            self._accum = np.zeros_like(ref, dtype=np.float64)
            self._count = np.zeros_like(ref, dtype=np.float64)
        self._accum += self.accum_func(left, right, mask)
        self._count += np.broadcast_to(mask, right.shape).sum(self.dim)
        return self

    def get(self) -> np.ndarray:
        if self._count is None or self._count.sum() == 0:
            return np.array([0.])
        ret = self._accum / self._count
        assert not np.isnan(ret).any()
        return ret

    def accum_func(self, left: np.ndarray, right: np.ndarray,
                   mask: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class L1Reg(AccumulativeMetric):
    def accum_func(self, left, right, mask):
        return np.abs((left - right) * mask).sum(self.dim)


class L2Reg(AccumulativeMetric):
    def accum_func(self, left, right, mask):
        return (((left - right) * mask) ** 2).sum(self.dim)

    @classmethod
    def reduce(cls, stats: tp.List[np.ndarray]) -> float:
        return float(np.sqrt(np.mean([np.mean(s) for s in stats])))


class ClassificationAcc(AccumulativeMetric):
    """Argmax accuracy; masked positions get two *different* invalid
    labels so they never count as correct."""

    def accum_func(self, left, right, mask):
        preds = left.argmax(1, keepdims=True).astype(np.int64)
        expected = np.array(right, copy=True).astype(np.int64)
        mask_b = np.broadcast_to(mask.astype(bool), preds.shape)
        preds = np.where(mask_b, preds, -1)
        expected = np.where(mask_b, expected, -2)
        return (preds == expected).sum(self.dim)
