"""Training losses and CLIP retrieval scoring.

Port of ``brainmagick_tpu/losses.py``: the masked L1/L2 losses, and
``ClipLoss``, which scores estimates [B, F, T] against candidates
[N, F, T] with the candidate norms folded in and, as a loss, takes the
weighted cross-entropy of each estimate against its own candidate.
``retrieval_scores`` is the no-grad fast path that contracts the
flattened [B, F*T] x [N, F*T] operands through the ``nt_matmul`` kernel.
"""

from __future__ import annotations

import typing as tp

import torch

from .ops.matmul import nt_matmul


def _torch_dtype(name: tp.Optional[str]) -> tp.Optional[torch.dtype]:
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


def _masked_reduce(err: torch.Tensor, mask: torch.Tensor,
                   sample_weight: tp.Optional[torch.Tensor]) -> torch.Tensor:
    mask = mask.expand(err.shape).to(err.dtype)
    if sample_weight is not None:
        mask = mask * sample_weight.reshape(-1, *([1] * (err.dim() - 1)))
    return torch.sum(err * mask) / torch.sum(mask).clamp(min=1.0)


def masked_l1(estimate: torch.Tensor, output: torch.Tensor,
              mask: torch.Tensor,
              sample_weight: tp.Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    return _masked_reduce((estimate - output).abs(), mask, sample_weight)


def masked_l2(estimate: torch.Tensor, output: torch.Tensor,
              mask: torch.Tensor,
              sample_weight: tp.Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    return _masked_reduce((estimate - output) ** 2, mask, sample_weight)


def block_inv_norms(block: torch.Tensor) -> torch.Tensor:
    """Per-candidate inverse norms of a (possibly bf16) candidate block,
    accumulated in fp32."""
    cf = block.reshape(block.shape[0], -1).float()
    return 1 / (1e-8 + torch.sqrt(torch.sum(cf * cf, dim=1)))


class ClipLoss:
    """CLIP scoring over candidate segments: trimming to a [tmin, tmax]
    window (``tmin_train``/``tmax_train`` in training), optional time
    pooling and centering, an optional matmul compute dtype (bf16
    operands, fp32 accumulation and norms). The learned ``linear``
    projection is not ported yet."""

    def __init__(self, linear: tp.Optional[int] = None, pool: bool = False,
                 center: bool = False, tmin: tp.Optional[float] = None,
                 tmax: tp.Optional[float] = None,
                 tmin_train: tp.Optional[float] = None,
                 tmax_train: tp.Optional[float] = None,
                 dset_tmin: float = -0.5,
                 dset_sample_rate: float = 120.,
                 compute_dtype: tp.Optional[str] = None,
                 est_layout: str = "bct") -> None:
        if linear:
            raise NotImplementedError(f"clip.linear={linear!r}")
        if est_layout != "bct":
            raise NotImplementedError(f"est_layout={est_layout!r}")
        self.linear = linear
        self.pool = pool
        self.center = center
        self.tmin, self.tmax = tmin, tmax
        self.tmin_train, self.tmax_train = tmin_train, tmax_train
        self.dset_tmin = dset_tmin
        self.dset_sample_rate = dset_sample_rate
        self.compute_dtype = _torch_dtype(compute_dtype)

    def trim_samples(self, estimates: torch.Tensor, candidates: torch.Tensor,
                     train: bool = False
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Restrict scoring to [tmin, tmax] relative to the event, or to
        [tmin_train, tmax_train] in training when either is set."""
        if train and (self.tmin_train is not None
                      or self.tmax_train is not None):
            tmin, tmax = self.tmin_train, self.tmax_train
        else:
            tmin, tmax = self.tmin, self.tmax
        trim_min, trim_max = 0, estimates.shape[-1]
        if tmin is not None:
            if tmin < self.dset_tmin:
                raise ValueError("clip.tmin must be >= dset.tmin")
            trim_min = int((-self.dset_tmin + tmin) * self.dset_sample_rate)
        if tmax is not None:
            trim_max = int((-self.dset_tmin + tmax) * self.dset_sample_rate)
        return (estimates[..., trim_min:trim_max],
                candidates[..., trim_min:trim_max])

    def get_scores(self, estimates: torch.Tensor, candidates: torch.Tensor,
                   train: bool = False) -> torch.Tensor:
        """[B, F, T] x [N, F, T] -> [B, N] candidate-norm-scaled scores."""
        estimates, candidates = self.trim_samples(estimates, candidates,
                                                  train)
        if self.pool:
            estimates = estimates.mean(dim=2, keepdim=True)
            candidates = candidates.mean(dim=2, keepdim=True)
        if self.center:
            estimates = estimates - estimates.mean(dim=(1, 2), keepdim=True)
            candidates = candidates - candidates.mean(dim=(1, 2),
                                                      keepdim=True)
        if self.compute_dtype is not None:
            estimates = estimates.to(self.compute_dtype)
            candidates = candidates.to(self.compute_dtype)
        # norms and the contraction in fp32 (a bf16 operand upcasts
        # exactly); matches the JAX einsum's fp32 accumulation
        e2 = estimates.reshape(estimates.shape[0], -1).float()
        c2 = candidates.reshape(candidates.shape[0], -1).float()
        return (e2 @ c2.T) * block_inv_norms(c2)[None, :]

    def get_probabilities(self, estimates: torch.Tensor,
                          candidates: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.get_scores(estimates, candidates), dim=1)

    def __call__(self, estimate: torch.Tensor, candidate: torch.Tensor,
                 sample_weight: tp.Optional[torch.Tensor] = None,
                 candidate_weight: tp.Optional[torch.Tensor] = None,
                 train: bool = False) -> torch.Tensor:
        """Cross-entropy over candidates; estimate i's positive is
        candidate i. `sample_weight` [B] masks estimates out of the loss,
        `candidate_weight` [N] masks candidates out of the softmax."""
        if estimate.shape[0] > candidate.shape[0]:
            raise ValueError("need at least as many candidates as "
                             "estimates")
        scores = self.get_scores(estimate, candidate, train=train)
        return self.loss_from_scores(scores, sample_weight, candidate_weight)

    @staticmethod
    def loss_from_scores(scores: torch.Tensor,
                         sample_weight: tp.Optional[torch.Tensor] = None,
                         candidate_weight: tp.Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Masked softmax cross-entropy over [B, N] scores; estimate i's
        positive is column i."""
        if candidate_weight is not None:
            # large finite negative (not -inf): a zero-weight row whose own
            # candidate is masked too stays NaN-free
            scores = torch.where(candidate_weight[None, :] > 0, scores,
                                 torch.full_like(scores, -1e30))
        logprobs = torch.log_softmax(scores, dim=1)
        diag = torch.diagonal(logprobs[:, :scores.shape[0]])
        if sample_weight is None:
            return -diag.mean()
        w = sample_weight.to(diag.dtype)
        return -(diag * w).sum() / w.sum().clamp(min=1.0)


def retrieval_scores(clip: ClipLoss, estimates: torch.Tensor,
                     candidates: torch.Tensor,
                     inv_norms: tp.Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """No-grad scoring fast path: the same scores as
    ``clip.get_scores``, with the flattened contraction
    run by ``nt_matmul``. A trim/transform configuration goes through
    ``clip.get_scores``. `inv_norms` are precomputed candidate inverse
    norms (``block_inv_norms``) for the fast path."""
    if (clip.pool or clip.center or clip.tmin is not None
            or clip.tmax is not None):
        if inv_norms is not None:
            raise ValueError("precomputed norms apply to the fast path only")
        return clip.get_scores(estimates, candidates)
    if clip.compute_dtype is not None:
        estimates = estimates.to(clip.compute_dtype)
        candidates = candidates.to(clip.compute_dtype)
    # the kernel takes contiguous rows (a no-op for contiguous inputs)
    e2 = estimates.reshape(estimates.shape[0], -1).contiguous()
    c2 = candidates.reshape(candidates.shape[0], -1).contiguous()
    if inv_norms is None:
        inv_norms = block_inv_norms(c2)
    return nt_matmul(e2, c2) * inv_norms[None, :]
