"""Training losses and CLIP retrieval scoring.

Port of ``brainmagick_tpu/losses.py``: the masked L1/L2 losses,
``FeatureDecodingLoss`` (per-feature regression and classification), and
``ClipLoss`` (an ``nn.Module``: the learned projection of ``clip.linear``
is its parameters), which scores estimates [B, F, T] against candidates
[N, F, T] with the candidate norms folded in and, as a loss, takes the
weighted cross-entropy of each estimate against its own candidate.
``retrieval_scores`` is the no-grad fast path that contracts the
flattened [B, F*T] x [N, F*T] operands through the ``nt_matmul`` kernel;
``streamed_scores`` runs it over a candidate pool streamed to the device
in blocks (``candidate_blocks``, ``iter_device_groups``,
``EstimateCache``), as the offline evaluation and WER do; as a rank of a
data-parallel run (``pool_scores``), on this rank's rows, or with the pool
passed around the ranks' ring (``ring_scores``). With ``test.pool_int8``
(``use_int8_pool``) the pool is quantized to int8 per candidate on the
host and the estimates per row on the device, and
``retrieval_scores_int8`` contracts them in int32 over K chunks that
cannot overflow (``torch._int_mm``, the JAX package's int8
``dot_general``); ``own_scores_int8`` scores a row's own output so.
"""

from __future__ import annotations

import dataclasses
import functools
import typing as tp

import numpy as np
import torch
from torch import nn

from . import parallel, tracing
from .models.common import lecun_normal_
from .ops.inv_norms import inv_norms as row_inv_norms
from .ops.matmul import nt_matmul
from .precision import torch_dtype


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


#: the largest integer a bf16 wire carries exactly (257 rounds to 256)
_BF16_EXACT = 256


def _log_softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.log_softmax`` as XLA computes it: the shift by the
    (constant) maximum in x's type, exp and its sum accumulated in fp32
    (one fused reduction) and rounded to x's type, log and the difference
    in x's type. In bf16 it rounds where XLA does; ``torch.log_softmax``
    rounds once, at the end."""
    shifted = x - x.amax(dim, keepdim=True).detach()
    total = torch.exp(shifted.float()).sum(dim, keepdim=True)
    return shifted - torch.log(total.to(x.dtype))


class FeatureDecodingLoss:
    """Per-feature losses over the ``FeaturesBuilder`` channel layout: the
    mean squared error of each regressed feature over its masked samples
    and channels, and for each categorical feature the cross-entropy of
    its ``cardinality`` logits against the class in its channel, weighted
    by ``BatchScaler.get_categorical_feature_weights`` when a `scaler` is
    given. The slices and weights are fixed at construction.

    `wire_dtype` is the type the targets cross to the device in
    (``parallel.transfer_dtype``): a categorical feature whose labels it
    cannot carry exactly is refused."""

    def __init__(self, used_features: tp.Any, scaler: tp.Any = None,
                 wire_dtype: tp.Any = None) -> None:
        self.specs: tp.List[tp.Dict[str, tp.Any]] = []
        self.input_dimension = used_features.dimension
        self.output_dimension = used_features.output_dimension
        bf16_wire = torch_dtype(wire_dtype) == torch.bfloat16
        for name, feature in used_features.items():
            sl_in = used_features.get_slice(name)
            sl_out = used_features.get_slice(name, model_output=True)
            weights = None
            if feature.categorical:
                if bf16_wire and feature.cardinality > _BF16_EXACT:
                    raise ValueError(
                        f"{name} has {feature.cardinality} classes, but a "
                        f"bf16 wire carries integers exactly up to "
                        f"{_BF16_EXACT} only")
                if scaler is not None:
                    weights = torch.from_numpy(
                        scaler.get_categorical_feature_weights(name))
            self.specs.append(dict(
                name=name, categorical=feature.categorical,
                sl_in=(sl_in.start, sl_in.stop),
                sl_out=(sl_out.start, sl_out.stop), weights=weights))

    def __call__(self, estimate: torch.Tensor, output: torch.Tensor,
                 mask: tp.Optional[torch.Tensor] = None,
                 sample_weight: tp.Optional[torch.Tensor] = None,
                 train: bool = False) -> torch.Tensor:
        """estimate [B, output_dimension, T], output [B, input_dimension,
        T], mask [B, 1, T] (all true when None), sample_weight [B]. The
        masks and sums take estimate's type, as in JAX."""
        assert estimate.shape[1] == self.output_dimension
        assert output.shape[1] == self.input_dimension
        if mask is None:
            mask = torch.ones((output.shape[0], 1, output.shape[-1]),
                              dtype=torch.bool, device=output.device)
        m = mask.to(estimate.dtype)
        if sample_weight is not None:
            m = m * sample_weight.reshape(-1, 1, 1)
        denom = m.sum().clamp(min=1.0)
        loss: tp.Any = 0.
        for spec in self.specs:
            i0, i1 = spec["sl_in"]
            o0, o1 = spec["sl_out"]
            target = output[:, i0:i1]
            pred = estimate[:, o0:o1]
            if spec["categorical"]:
                labels = target[:, 0].long()                    # [B, T]
                logp = _log_softmax(pred.transpose(1, 2), -1)   # [B, T, K]
                nll = -logp.gather(-1, labels[..., None])[..., 0]
                wm = m[:, 0]
                if spec["weights"] is not None:
                    spec["weights"] = spec["weights"].to(estimate.device)
                    cw = spec["weights"][labels]
                    nll = nll * cw
                    loss = loss + (nll * wm).sum() \
                        / (cw * wm).sum().clamp(min=1e-8)
                else:
                    loss = loss + (nll * wm).sum() / denom
            else:
                err = (pred - target) ** 2
                loss = loss + (err * m).sum() / (denom * (i1 - i0))
        return loss


def block_inv_norms(block: torch.Tensor) -> torch.Tensor:
    """Per-candidate inverse norms of a (possibly bf16) candidate block,
    accumulated in fp32: the training loss's differentiable version. The
    JAX package's values; the gradient of an all-zero candidate's norm is
    0 here, where the JAX package's square root at 0 makes it NaN (the
    zero-weight padding of the sampled negatives through ``clip.linear``'s
    projection, at its zero initial bias, then turns the projection's
    gradients into NaN there). The no-grad scoring sites take the same
    values from the one-pass kernel, ``ops.inv_norms``."""
    cf = block.reshape(block.shape[0], -1).float()
    squares = torch.sum(cf * cf, dim=1)
    positive = squares > 0
    norms = torch.where(positive, torch.sqrt(torch.where(
        positive, squares, torch.ones_like(squares))), 0.)
    return 1 / (1e-8 + norms)


class ClipLoss(nn.Module):
    """CLIP scoring over candidate segments: trimming to a [tmin, tmax]
    window (``tmin_train``/``tmax_train`` in training), the learned
    ``linear`` projection over the trimmed time axis, optional time
    pooling and centering, an optional matmul compute dtype (bf16
    operands, fp32 accumulation and norms).

    With `linear`, the projection is flax's lazy ``Dense`` over time: its
    input width is the eval-mode trim of the targets' `length` (flax
    creates it in ``init``, which runs in eval mode), and in training the
    ``tmin_train``/``tmax_train`` trim must give the same width. It maps
    the estimates through ``linear_est`` and the candidates through the
    same layer with `twin`, else through ``linear_gt``, each initialized
    by ``reset_parameters`` (``solver.build_clip_loss`` calls it), its
    product in its input's type promoted with fp32. `est_layout` "btc"
    takes the estimates as [B, T, F]."""

    def __init__(self, linear: tp.Optional[int] = None, twin: bool = True,
                 pool: bool = False, center: bool = False,
                 tmin: tp.Optional[float] = None,
                 tmax: tp.Optional[float] = None,
                 tmin_train: tp.Optional[float] = None,
                 tmax_train: tp.Optional[float] = None,
                 dset_tmin: float = -0.5,
                 dset_sample_rate: float = 120.,
                 compute_dtype: tp.Optional[str] = None,
                 est_layout: str = "bct",
                 length: tp.Optional[int] = None) -> None:
        super().__init__()
        if est_layout not in ("bct", "btc"):
            raise ValueError(f"est_layout={est_layout!r}: 'bct' or 'btc'")
        self.linear = linear
        self.twin = twin
        self.pool = pool
        self.center = center
        self.tmin, self.tmax = tmin, tmax
        self.tmin_train, self.tmax_train = tmin_train, tmax_train
        self.dset_tmin = dset_tmin
        self.dset_sample_rate = dset_sample_rate
        self.compute_dtype = torch_dtype(compute_dtype)
        self.est_layout = est_layout
        self.linear_est: tp.Optional[nn.Linear] = None
        self.linear_gt: tp.Optional[nn.Linear] = None
        if linear:
            if length is None:
                raise ValueError("clip.linear needs the targets' length "
                                 "(the projection's input width)")
            lo, hi = self._bounds(length, False)
            width = len(range(length)[lo:hi])
            self.linear_est = nn.Linear(width, linear)
            if not twin:
                self.linear_gt = nn.Linear(width, linear)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``Dense``'s initialization of the projection: a LeCun
        normal kernel drawn from `generator`, a zero bias."""
        for layer in (self.linear_est, self.linear_gt):
            if layer is not None:
                lecun_normal_(layer.weight, layer.in_features, generator)
                nn.init.zeros_(layer.bias)

    def _bounds(self, length: int, train: bool) -> tp.Tuple[int, int]:
        """The [lo, hi) sample window of the trim for `length` samples."""
        if train and (self.tmin_train is not None
                      or self.tmax_train is not None):
            tmin, tmax = self.tmin_train, self.tmax_train
        else:
            tmin, tmax = self.tmin, self.tmax
        trim_min, trim_max = 0, length
        if tmin is not None:
            if tmin < self.dset_tmin:
                raise ValueError("clip.tmin must be >= dset.tmin")
            trim_min = int((-self.dset_tmin + tmin) * self.dset_sample_rate)
        if tmax is not None:
            trim_max = int((-self.dset_tmin + tmax) * self.dset_sample_rate)
        return trim_min, trim_max

    def trim_samples(self, estimates: torch.Tensor, candidates: torch.Tensor,
                     train: bool = False
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Restrict scoring to [tmin, tmax] relative to the event, or to
        [tmin_train, tmax_train] in training when either is set; [B, F, T]
        estimates and candidates."""
        lo, hi = self._bounds(estimates.shape[-1], train)
        return estimates[..., lo:hi], candidates[..., lo:hi]

    @staticmethod
    def _project(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """flax ``Dense`` with ``dtype=None`` over the last axis: input and
        parameters promoted to one type."""
        dt = torch.promote_types(x.dtype, layer.weight.dtype)
        return torch.nn.functional.linear(x.to(dt), layer.weight.to(dt),
                                          layer.bias.to(dt))

    def _flat_operands(self, estimates: torch.Tensor,
                       candidates: torch.Tensor, train: bool
                       ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """The trimmed, projected, pooled, centered and compute-dtype cast
        operands, flattened to [B, F*T'] and [N, F*T'] in fp32."""
        if self.est_layout == "btc":
            estimates = estimates.transpose(1, 2)
        estimates, candidates = self.trim_samples(estimates, candidates,
                                                  train)
        if self.linear_est is not None:
            estimates = self._project(self.linear_est, estimates)
            candidates = self._project(self.linear_gt or self.linear_est,
                                       candidates)
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
        return (estimates.reshape(estimates.shape[0], -1).float(),
                candidates.reshape(candidates.shape[0], -1).float())

    def get_scores(self, estimates: torch.Tensor, candidates: torch.Tensor,
                   train: bool = False) -> torch.Tensor:
        """[B, F, T] (or [B, T, F] with est_layout "btc") x [N, F, T] ->
        [B, N] candidate-norm-scaled scores."""
        e2, c2 = self._flat_operands(estimates, candidates, train)
        return (e2 @ c2.T) * block_inv_norms(c2)[None, :]

    def own_scores(self, estimates: torch.Tensor,
                   outputs: torch.Tensor) -> torch.Tensor:
        """[B, F, T] x [B, F, T] -> [B]: each estimate's score against its
        own output, the diagonal of ``get_scores(estimates, outputs)``
        without the [B, B] product (the JAX package maps ``get_scores``
        over the row pairs)."""
        e2, o2 = self._flat_operands(estimates, outputs, False)
        return (e2 * o2).sum(dim=1) * block_inv_norms(o2)

    def get_probabilities(self, estimates: torch.Tensor,
                          candidates: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.get_scores(estimates, candidates), dim=1)

    def forward(self, estimate: torch.Tensor, candidate: torch.Tensor,
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


def int8_retrieval_ok(clip: ClipLoss) -> bool:
    """Whether `clip` is the fast-path configuration (no projection,
    pooling, centering or trim window): the one where
    ``retrieval_scores`` contracts the flattened operands, and the one
    the JAX package scores an int8 pool in."""
    return not (clip.linear or clip.pool or clip.center
                or clip.tmin is not None or clip.tmax is not None)


def use_int8_pool(args: tp.Any, clip: ClipLoss) -> bool:
    """Whether the pool is scored in int8: ``test.pool_int8`` on a
    fast-path configuration, as the JAX package decides it (any other
    configuration scores as it would without the option)."""
    return bool(getattr(args.test, "pool_int8", False)) \
        and int8_retrieval_ok(clip)


#: the largest K chunk whose int32 sum of int8 products cannot overflow,
#: even for two rows of 127s: 127^2 K < 2^31 (the JAX package's chunks)
INT8_K_CHUNK = (2 ** 31 - 1) // (127 * 127)


def quantize_candidates(block: np.ndarray) -> np.ndarray:
    """Per-candidate symmetric int8 on the host, as the JAX package's
    ``candidate_blocks(int8=True)``: each candidate over its max |x| /
    127 (at least 1e-12), ``np.rint`` (half to even), clipped to +-127.
    No scale is kept: it cancels from the norm-folded score,
    est . (s q) / |s q| = est . q / |q|."""
    block = np.asarray(block).astype(np.float32)
    amax = np.abs(block).reshape(len(block), -1).max(axis=1)
    scale = np.maximum(amax / 127.0, 1e-12)
    q = np.rint(block / scale.reshape(-1, *([1] * (block.ndim - 1))))
    return np.clip(q, -127, 127).astype(np.int8)


def _int8_quantize_rows(x2: torch.Tensor
                        ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of [N, K] rows on their device: (int8 [N, K],
    fp32 scale [N]) with x ~= scale[:, None] q; ``torch.round`` rounds
    half to even, as ``jnp.round``."""
    x2 = x2.float()
    # a divisor on the rows' device: a CPU scalar would turn the division
    # into a product by its reciprocal on CUDA
    top = torch.full((), 127.0, device=x2.device)
    s = torch.clamp(x2.abs().amax(dim=1) / top, min=1e-12)
    q = torch.clamp(torch.round(x2 / s[:, None]), -127, 127)
    return q.to(torch.int8), s


#: the columns each K chunk takes in an operand laid out for the card's
#: int8 GEMM: INT8_K_CHUNK rounded up to a multiple of 128. cuBLAS's int8
#: GEMM (``torch._int_mm``) takes twice as long at a K that is not a
#: multiple of 16 (the chunk's 133,144 is 8 past one)
INT8_K_ALIGN = 128


@dataclasses.dataclass
class Int8Rows:
    """int8 rows [n, K] as ``int8_partial_sums`` takes them: `chunks`, the
    rows' K chunks (INT8_K_CHUNK wide, the last one shorter), each an
    operand of ``torch._int_mm``, and `rows`, n. The chunks
    (``int8_rows``) are views of one zero-filled buffer: each chunk padded
    to a multiple of INT8_K_ALIGN columns and starting on a 16-byte
    boundary, the rows padded to a multiple of 16, at least 32
    (``torch._int_mm`` takes more than 16 rows and K and N multiples of 8
    on the card); zeros add nothing to an integer product."""
    rows: int
    chunks: tp.List[torch.Tensor]

    @property
    def nbytes(self) -> int:
        return sum(chunk.nbytes for chunk in self.chunks)


def int8_rows(q2: torch.Tensor) -> Int8Rows:
    """[n, K] int8 rows laid out as ``Int8Rows``: once a block or a chunk
    of rows, so that every product with them reads them as they are."""
    n, k = q2.shape
    bounds = range(0, k, INT8_K_CHUNK)
    widths = [min(INT8_K_CHUNK, k - lo) for lo in bounds]
    padded = [-(-w // INT8_K_ALIGN) * INT8_K_ALIGN for w in widths]
    buf = q2.new_zeros((max(32, -(-n // 16) * 16), sum(padded)))
    chunks, at = [], 0
    for lo, width, columns in zip(bounds, widths, padded):
        buf[:n, at:at + width] = q2[:, lo:lo + width]
        chunks.append(buf[:, at:at + columns])
        at += columns
    return Int8Rows(n, chunks)


def int8_partial_sums(e_q: tp.Any, c_q: tp.Any) -> tp.List[torch.Tensor]:
    """The exact int32 products ``e_q[:, K_j] c_q[:, K_j]^T`` [M, N] over
    the K chunks of INT8_K_CHUNK, by ``torch._int_mm`` (cuBLAS's int8
    GEMM on the card), of int8 rows [M, K] and [N, K] or their ``Int8Rows``
    (``int8_rows`` lays a tensor out first)."""
    e_q, c_q = (x if isinstance(x, Int8Rows) else int8_rows(x)
                for x in (e_q, c_q))
    m, n = e_q.rows, c_q.rows
    return [torch._int_mm(a, b.t())[:m, :n]
            for a, b in zip(e_q.chunks, c_q.chunks)]


def retrieval_scores_int8(estimates: tp.Any, cand_q: tp.Any,
                          inv_norms: tp.Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """No-grad scores against an int8 candidate block (``candidate_blocks``
    with `int8`, or its ``int8_rows`` with `inv_norms`), as the JAX
    package's: the estimates quantized per row (or a prepared ``(e_q,
    s_e)`` pair, ``EstimateCache``), the int32 partial sums
    (``int8_partial_sums``) added in fp32 in K order, then ``acc *
    s_e[:, None] * inv_norms[None, :]`` with the candidates' inverse norms
    of their int8 values (``ops.inv_norms``)."""
    if not isinstance(cand_q, Int8Rows):
        cand_q = cand_q.reshape(cand_q.shape[0], -1)
        if inv_norms is None:
            inv_norms = row_inv_norms(cand_q)
    elif inv_norms is None:
        raise ValueError("laid-out candidates need their inverse norms")
    if isinstance(estimates, tuple):
        e_q, s_e = estimates
    else:
        e_q, s_e = _int8_quantize_rows(
            estimates.reshape(estimates.shape[0], -1))
    acc = None
    for part in int8_partial_sums(e_q, cand_q):
        part = part.float()
        acc = part if acc is None else acc + part
    return acc * s_e[:, None] * inv_norms[None, :]


def own_scores_int8(est: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
    """Each row's score against its own output with both sides quantized
    per row, so that the own column of the WER softmax carries the
    quantization noise of its pool competitors (``wer.get_wer``'s own
    column under ``test.pool_int8``)."""
    e_q, s_e = _int8_quantize_rows(est.reshape(est.shape[0], -1))
    o_q, _ = _int8_quantize_rows(own.reshape(own.shape[0], -1))
    ef, of = e_q.float(), o_q.float()
    acc = torch.sum(ef * of, dim=1)
    inv = 1 / (1e-8 + torch.sqrt(torch.sum(of * of, dim=1)))
    return acc * s_e * inv


def retrieval_scores(clip: ClipLoss, estimates: torch.Tensor,
                     candidates: torch.Tensor,
                     inv_norms: tp.Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """No-grad scoring fast path: the same scores as
    ``clip.get_scores``, with the flattened contraction
    run by ``nt_matmul``. A trim/transform configuration goes through
    ``clip.get_scores``. `inv_norms` are precomputed candidate inverse
    norms (``ops.inv_norms``) for the fast path."""
    if not int8_retrieval_ok(clip):
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
        with tracing.span("inv_norms"):
            inv_norms = row_inv_norms(c2)
    with tracing.span("nt_matmul"):
        return nt_matmul(e2, c2) * inv_norms[None, :]


#: candidates per block in the evaluation's streamed scoring
CANDIDATE_BLOCK = 2048


def candidate_blocks(pool: tp.Any, compute_dtype: tp.Optional[torch.dtype],
                     block_size: int = CANDIDATE_BLOCK, pin: bool = False,
                     int8: bool = False) -> tp.List[torch.Tensor]:
    """Host-side candidate blocks of `block_size` rows in the score compute
    dtype (the pool's own dtype when None).

    On the host on purpose: the whole pool need not fit on the card (20k
    wav2vec-width candidates are 28 GB in fp32), so callers move a bounded
    group at a time (``iter_device_groups``). A bf16 compute dtype halves
    both the stream and the resident group, and the norms use the same
    cast values, so the scores equal an in-call cast. With `pin` the
    blocks are views of one page-locked buffer, which a copy to the card
    reads asynchronously.

    With `int8` the blocks are the pool quantized per candidate
    (``quantize_candidates``, a quarter of fp32's bytes), whatever the
    compute dtype.

    The JAX function zero-pads the tail block to keep its jitted shapes
    fixed and slices the padded columns off the scores; the scoring calls
    here take any N, so the tail block is left short, with the same
    scores."""
    if int8:
        host = torch.empty(np.shape(pool), dtype=torch.int8, pin_memory=pin)
        for lo in range(0, len(pool), block_size):
            host[lo:lo + block_size] = torch.from_numpy(quantize_candidates(
                np.asarray(pool[lo:lo + block_size])))
        return list(host.split(block_size))
    src = pool if isinstance(pool, torch.Tensor) else torch.as_tensor(
        np.asarray(pool))
    host = torch.empty(src.shape, dtype=compute_dtype or src.dtype,
                       pin_memory=pin)
    host.copy_(src)
    return list(host.split(block_size))


def iter_device_groups(blocks: tp.Sequence[torch.Tensor],
                       device: tp.Union[str, torch.device],
                       budget_bytes: int = 4 << 30
                       ) -> tp.Iterator[tp.Tuple[int, tp.List[torch.Tensor]]]:
    """Yield (first block index, [blocks on `device`]) groups of candidate
    blocks whose size together stays under `budget_bytes`; the caller
    drops each group before the next iteration.

    The next group's copy is issued before the current group is yielded,
    and the group is halved so that both fit the budget (when every block
    fits in one group there is nothing to overlap and the full budget
    applies), as in the JAX function's default. On a CUDA device the
    copies run on a side stream from the pinned blocks
    (``candidate_blocks(pin=True)``, which the caller keeps alive): the
    scoring stream waits on a group's copy before it gets the group, and
    each block is marked as used by that stream, so that its memory is not
    handed to the next copy before the scoring that reads it is done."""
    if not blocks:
        return
    per = max(blocks[0].nbytes, 1)
    group = max(1, int(budget_bytes // per))
    if len(blocks) > group:
        group = max(1, int(budget_bytes // 2 // per))
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(i: int):
        part = blocks[i:i + group]
        if side is None:
            return [b.to(device) for b in part], None
        with torch.cuda.stream(side):
            moved = [b.to(device, non_blocking=True) for b in part]
        done = torch.cuda.Event()
        done.record(side)
        return moved, done

    def take(pending) -> tp.List[torch.Tensor]:
        moved, done = pending
        if done is not None:
            scoring = torch.cuda.current_stream(device)
            scoring.wait_event(done)
            for block in moved:
                block.record_stream(scoring)
        return moved

    starts = list(range(0, len(blocks), group))
    nxt = None
    for j, i in enumerate(starts):
        cur = take(nxt if nxt is not None else put(i))
        nxt = put(starts[j + 1]) if j + 1 < len(starts) else None
        yield i, cur
        del cur


def commit_rows(rows: tp.Any, device: torch.device) -> torch.Tensor:
    """Estimate or prediction rows (numpy or a tensor) on `device`."""
    return torch.as_tensor(rows).to(device)


class EstimateCache:
    """Per-chunk prepared estimate rows for streamed retrieval scoring
    (``wer.get_wer``, ``eval.build_probs``).

    The scoring loops run candidate groups outer and estimate chunks
    inner. Preparing a chunk (its copy to the device and its cast to the
    compute dtype) inside the scoring call would pay it once per candidate
    block; this cache prepares a chunk once and keeps the prepared rows
    across groups while they fit `budget_bytes`. Over the budget a chunk
    is prepared once per (group, chunk) and not kept, as in the JAX
    package. `commits` and `committed_bytes` count the copies. With
    `use_int8` a chunk is prepared as ``retrieval_scores_int8`` takes it:
    the ``(int8_rows(e_q), s_e)`` pair of its flattened rows."""

    def __init__(self, clip: ClipLoss, device: torch.device,
                 budget_bytes: int = 2 << 30, use_int8: bool = False) -> None:
        self.device = torch.device(device)
        self.budget = int(budget_bytes)
        self._cache: tp.Dict[int, tp.Any] = {}
        self._bytes = 0
        self.commits = self.committed_bytes = 0
        self.use_int8 = use_int8
        self._dtype = clip.compute_dtype if int8_retrieval_ok(clip) else None

    def get(self, lo: int, make_chunk: tp.Callable[[], tp.Any]) -> tp.Any:
        hit = self._cache.get(lo)
        if hit is not None:
            return hit
        rows = commit_rows(make_chunk(), self.device)
        self.commits += 1
        self.committed_bytes += rows.nbytes
        if self.use_int8:
            e_q, s_e = _int8_quantize_rows(rows.reshape(len(rows), -1))
            prepared = (int8_rows(e_q), s_e)
        elif self._dtype is not None:
            prepared = rows.to(self._dtype)
        else:
            prepared = rows
        nbytes = (sum(part.nbytes for part in prepared)
                  if isinstance(prepared, tuple) else prepared.nbytes)
        if self._bytes + nbytes <= self.budget:
            self._cache[lo] = prepared
            self._bytes += nbytes
        return prepared


def streamed_scores(clip: ClipLoss, rows: tp.Any, pool: tp.Any,
                    device: torch.device, chunk: int = 2048,
                    stats: tp.Optional[tp.Dict[str, int]] = None,
                    use_int8: bool = False) -> np.ndarray:
    """[len(rows), len(pool)] fp32 retrieval scores on the host: the pool
    streamed to `device` in blocks of CANDIDATE_BLOCK and in groups, every
    chunk of `chunk` rows scored against each block of a group before the
    next group lands, as ``wer.get_wer`` and ``eval.build_probs`` do in
    the JAX package. Chunks are not padded to `chunk` rows (the JAX loops
    pad them only to keep jitted shapes fixed; each row's scores are its
    own). With `use_int8` (``use_int8_pool``) the pool streams as int8
    blocks and each chunk is quantized once (``EstimateCache``), and
    ``retrieval_scores_int8`` scores them.

    `stats`, when given, gains the counts of the transfers: ``groups``,
    ``pool_bytes`` (the pool's host-to-device bytes), ``commits`` and
    ``commit_bytes`` (the chunks')."""
    n = len(rows)
    scores = np.empty((n, len(pool)), dtype=np.float32)
    fast = int8_retrieval_ok(clip)
    host_blocks = candidate_blocks(pool, clip.compute_dtype, CANDIDATE_BLOCK,
                                   pin=device.type == "cuda", int8=use_int8)
    cache = EstimateCache(clip, device, use_int8=use_int8)
    score = retrieval_scores_int8 if use_int8 else functools.partial(
        retrieval_scores, clip)
    groups = pool_bytes = 0
    for g0, dev_group in iter_device_groups(host_blocks, device):
        groups += 1
        pool_bytes += sum(block.nbytes for block in dev_group)
        # candidate norms once per transferred block, not per chunk, and
        # int8 blocks laid out for the int8 GEMM once
        norms = [row_inv_norms(b) if fast else None for b in dev_group]
        if use_int8:
            dev_group = [int8_rows(b.reshape(len(b), -1)) for b in dev_group]
        for lo in range(0, n, chunk):
            est = cache.get(lo, lambda: rows[lo:lo + chunk])
            # index into the group: no loop variable keeps a block alive
            # while the next group lands
            for bi in range(len(dev_group)):
                c0 = (g0 + bi) * CANDIDATE_BLOCK
                s = score(est, dev_group[bi], norms[bi])
                scores[lo:lo + len(s), c0:c0 + s.shape[1]] = s.cpu().numpy()
        del dev_group, norms
    if stats is not None:
        for key, value in (("groups", groups), ("pool_bytes", pool_bytes),
                           ("commits", cache.commits),
                           ("commit_bytes", cache.committed_bytes)):
            stats[key] = stats.get(key, 0) + value
    return scores


def ring_scores(group: tp.Any, estimates: tp.Any, pool: tp.Any,
                compute_dtype: tp.Optional[torch.dtype],
                device: torch.device) -> np.ndarray:
    """[n, P] fp32 retrieval scores on every rank of `group`
    (``parallel.DataGroup``) with the pool split over the ranks and passed
    around their ring: each rank holds one block of the estimates' rows
    and one block of the pool, scores its rows against the block it holds
    (``nt_matmul``, norms of the compute-dtype values, as
    ``retrieval_scores``), then passes that block to its left neighbour,
    until it has scored every block; the score rows are then gathered.
    The host-to-card traffic of the pool is one copy over all the ranks,
    and each card holds a rank's share of it. Rows and pool are padded to
    multiples of the ranks with zero rows, whose scores are dropped."""
    size, rank = group.size, group.rank
    est = torch.as_tensor(np.asarray(estimates))
    cand = torch.as_tensor(np.asarray(pool))
    n, p = len(est), len(cand)
    n_loc, p_loc = -(-n // size), -(-p // size)

    def block(x: torch.Tensor, per: int) -> torch.Tensor:
        part = x[rank * per:(rank + 1) * per]
        part = part.reshape(len(part), -1)
        pad = per - len(part)
        if pad:
            part = torch.cat([part, part.new_zeros((pad, part.shape[1]))])
        part = part.to(device)
        return part.to(compute_dtype) if compute_dtype is not None \
            else part.contiguous()

    e_loc, c_cur = block(est, n_loc), block(cand, p_loc)
    inv = row_inv_norms(c_cur)
    out = torch.empty((n_loc, size * p_loc), dtype=torch.float32,
                      device=device)
    pool_group = group.pool(size)
    for hop in range(size):
        # after `hop` passes this rank holds the block of rank + hop
        origin = (rank + hop) % size
        out[:, origin * p_loc:(origin + 1) * p_loc] = \
            nt_matmul(e_loc, c_cur) * inv[None, :]
        if hop + 1 < size:
            c_cur, inv = parallel.exchange([c_cur, inv], pool_group.left,
                                           pool_group.right, group.backend)
    return group.all_gather(out)[:n, :p].cpu().numpy()


def maybe_ring_scores(server: tp.Any, clip: ClipLoss, estimates: tp.Any,
                      pool: tp.Any, budget_bytes: int = 4 << 30,
                      use_int8: bool = False) -> tp.Optional[np.ndarray]:
    """``ring_scores`` when ``parallel.ring_scoring`` is on and the
    configuration qualifies, else None (the caller streams the pool): a
    group of more than one rank, the fast-path ClipLoss (no trim window or
    transform: the flattened contraction), no int8 pool (`use_int8`, as
    the JAX package declines it), non-empty operands, and each rank's
    share (its pool block, its estimate rows and its fp32 score rows)
    within `budget_bytes`. Never across hosts: on several hosts each host
    scores its own rows against its own pool, and the JAX package turns
    ring scoring off with several processes."""
    group = getattr(server, "group", None)
    if not server.args.parallel.ring_scoring or group is None \
            or group.size < 2 or use_int8 or not int8_retrieval_ok(clip) \
            or group.n_hosts > 1:
        return None
    if not len(estimates) or not len(pool):
        return None
    itemsize = torch.empty((), dtype=clip.compute_dtype).element_size() \
        if clip.compute_dtype is not None else np.asarray(pool).itemsize
    k = int(np.prod(np.shape(pool)[1:]))
    n, p = len(estimates), len(pool)
    per_rank = (p * k * itemsize + n * k * itemsize + n * p * 4) / group.size
    if per_rank > budget_bytes:
        return None
    return ring_scores(group, estimates, pool, clip.compute_dtype,
                       server.device)


def pool_scores(server: tp.Any, clip: ClipLoss, rows: tp.Any, pool: tp.Any,
                chunk: int = 2048,
                stats: tp.Optional[tp.Dict[str, int]] = None) -> np.ndarray:
    """[len(rows), len(pool)] fp32 retrieval scores on the host, as
    ``wer.get_wer`` and ``eval.build_probs`` take them, in int8 when
    ``use_int8_pool`` says so: alone, ``streamed_scores`` on the server's
    device; as a rank of a group (``server.group``), ``maybe_ring_scores``,
    or each rank's block of the rows (``DataGroup.split``) streamed against
    the whole pool and the blocks gathered, so that every rank has every
    row's scores. On several hosts, `rows` and `pool` are the host's and
    the split runs over the host's ranks (``DataGroup.host``)."""
    group = getattr(server, "group", None)
    if group is not None and group.n_hosts > 1:
        group = group.host
    use_int8 = use_int8_pool(server.args, clip)
    if group is None or group.size == 1:
        return streamed_scores(clip, rows, pool, server.device, chunk=chunk,
                               stats=stats, use_int8=use_int8)
    ring = maybe_ring_scores(server, clip, rows, pool, use_int8=use_int8)
    if ring is not None:
        return ring
    mine = streamed_scores(clip, rows[group.split(len(rows))], pool,
                           server.device, chunk=chunk, stats=stats,
                           use_int8=use_int8)
    return group.gather_split(torch.from_numpy(mine).to(server.device),
                              len(rows)).cpu().numpy()
