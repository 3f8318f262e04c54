"""The solver: normalize -> task wiring -> model -> loss, the training
step, and the epoch loop over datasets.

Port of ``brainmagick_tpu/solver.py``, on one device or as one rank of a
data-parallel run (``set_group``, the counterpart of the JAX solver's
``set_mesh``). ``Solver(args, model,
norm_arrays, ...)`` is the
per-batch engine that ``serve.Server`` and ``train.Trainer`` hold: its
normalization arrays keep the JAX solver's ``norm_arrays`` layout
(``meg_center``/``meg_scale`` [R, C], ``feat_center``/``feat_scale``
[F], ``pos_emb`` [R, C, pos_dim], ``rec_positions`` [R, C, 2],
``rec_subjects`` [R]) as tensors on the model's device
(``prepare_norm_arrays``). ``Solver.from_datasets`` builds the same
engine from the datasets, as the JAX constructor does: the scaler fitted
on the train split (through the disk cache), the normalization arrays
exported from it, the loaders, and a restore from the XP folder's
checkpoint; ``train`` then runs the epochs with validation, early
stopping, the test stage and a checkpoint after each epoch.

The train step's options: ``optim.negatives`` tops the CLIP candidates
up from a pool of past targets per phase (kept on the host, updated from
each step's targets newest first and cut to ``negative_pool_size``;
sampled with a numpy ``RandomState`` seeded from seed, epoch and phase,
the JAX solver's draws), and ``optim.svd`` adds the top-singular-value
penalty of the model's weights (``svd.svd_penalty``) to the train loss.
"""

from __future__ import annotations

import json
import logging
import time
import types
import typing as tp

import numpy as np
import torch
from torch.profiler import record_function

from .cache import Cache, tagged
from .convert import (FM_PREFIX, JAX_CHECKPOINT, LOSS_PREFIX,
                      load_jax_checkpoint, load_jax_optimizer_state,
                      load_jax_params)
from .dataset import ARRAY_FIELDS, to_device
from .loader import Loader
from .logging_utils import MetricSinks
from .losses import ClipLoss, FeatureDecodingLoss, masked_l1, masked_l2
from .models.common import fourier_emb
from .models.simpleconv import SimpleConv
from .norm import BatchScaler
from .ops.dsp import DSP_VERSION, lowpass_filter
from .ops.norm import INPUT_TYPES, normalize_clamp_peak
from .parallel import (DataGroup, all_gather, gather_rows, rank_seed,
                       replicate, ring_hop)
from .precision import deterministic_cudnn, exact_fp32
from .studies.api import INVALID_POSITION
from .svd import svd_penalty
from .utils import write_and_rename

logger = logging.getLogger(__name__)

class _AlwaysApply:
    """The SVD penalty's stand-in RNG: the step always applies it, as the
    JAX step does."""

    def random(self) -> float:
        return 0.


_ALWAYS = _AlwaysApply()


def _on(value: tp.Any, device: torch.device) -> torch.Tensor:
    """A tensor, or a numpy / JAX array, as a tensor on `device`."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    return value.to(device)


def prepare_norm_arrays(model: torch.nn.Module,
                        norm_arrays: tp.Mapping[str, tp.Any],
                        device: torch.device) -> tp.Dict[str, torch.Tensor]:
    """The JAX solver's ``norm_arrays`` (numpy or tensors) on `device`;
    ``pos_emb`` is computed from ``rec_positions`` when absent, as
    ``Solver._pos_emb_table`` does, for a model with a merger."""
    na = {name: _on(value, device)
          for name, value in norm_arrays.items() if value is not None}
    if getattr(model, "merger", None) is not None and "pos_emb" not in na:
        na["pos_emb"] = fourier_emb(na["rec_positions"],
                                    model.merger_pos_dim)
    return na


def build_clip_loss(args: tp.Any, device: tp.Union[str, torch.device],
                    length: tp.Optional[int] = None
                    ) -> tp.Optional[ClipLoss]:
    """The CLIP loss of ``optim.loss='clip'`` on `device` (None for any
    other loss). With ``clip.linear`` its projection's input width comes
    from `length`, the targets' time length (a segment's samples less the
    MEG offset), and its weights from a CPU generator seeded ``seed``."""
    if args.optim.loss != "clip":
        return None
    c = args.clip
    clip_loss = ClipLoss(
        linear=c.linear, twin=c.twin, pool=c.pool, center=c.center,
        tmin=c.tmin, tmax=c.tmax, tmin_train=c.tmin_train,
        tmax_train=c.tmax_train, dset_tmin=args.dset.tmin,
        dset_sample_rate=args.dset.sample_rate,
        compute_dtype=c.compute_dtype, length=length)
    clip_loss.reset_parameters(torch.Generator().manual_seed(args.seed))
    return clip_loss.to(device)


def target_length(args: tp.Any, features_length: int) -> int:
    """The targets' time length for features of `features_length`
    samples: less the MEG offset (``task.offset_meg_ms``)."""
    off = int(args.task.offset_meg_ms / 1000 * args.dset.sample_rate)
    return features_length - off


class Solver:
    """Forward, loss and training step of a decode- or encode-task model
    (a SimpleConv, or a ConvRNN, which takes no positions and has no
    merger).

    `args` is a port or JAX ``MainConfig``; options the port does not
    cover raise NotImplementedError here, at construction. `optimizer`
    (``train.build_optimizer``) is needed by a training step only;
    `generator` draws the merger's and ChannelDropout's disks and the
    dropout masks in train mode. `feature_model`
    (``models.build_feature_model``), which ``feature_model_name`` asks
    for, maps the ground truth to the targets of the loss, and trains with
    the model. `clip_loss` (``build_clip_loss``) is the CLIP loss, whose
    projection trains with the model; built here when None (without
    ``clip.linear``, which needs the targets' length). `used_features`
    (the datasets' ``FeaturesBuilder``) lays out the targets of
    ``optim.loss='regression_classification'``, and `scaler` (the fitted
    ``BatchScaler``) gives its class weights when
    ``optim.use_weighting``."""

    def __init__(self, args: tp.Any, model: torch.nn.Module,
                 norm_arrays: tp.Mapping[str, torch.Tensor],
                 optimizer: tp.Optional[torch.optim.Optimizer] = None,
                 generator: tp.Optional[torch.Generator] = None,
                 feature_model: tp.Optional[torch.nn.Module] = None,
                 used_features: tp.Any = None,
                 scaler: tp.Optional[BatchScaler] = None,
                 clip_loss: tp.Optional[ClipLoss] = None) -> None:
        if args.task.type not in ("decode", "encode"):
            raise ValueError(f"Unknown task {args.task.type}")
        if (args.feature_model_name is None) != (feature_model is None):
            raise ValueError(
                f"feature_model_name={args.feature_model_name!r} with "
                f"feature model {type(feature_model).__name__}")
        optim = args.optim
        if optim.loss not in ("clip", "l1", "mse",
                              "regression_classification"):
            raise NotImplementedError(f"optim.loss={optim.loss!r}")
        if optim.negatives is not None and optim.loss != "clip":
            raise ValueError(f"optim.negatives={optim.negatives!r} needs "
                             f"optim.loss='clip'")
        self.args = args
        self.model = model
        self.feature_model = feature_model
        self.device = next(model.parameters()).device
        self.norm_arrays = dict(norm_arrays)
        self.optimizer = optimizer
        self.generator = generator
        self.used_features = used_features
        self.scaler = scaler
        #: the epoch loop's datasets (``from_datasets``)
        self.datasets: tp.Any = None
        #: the data-parallel run this solver is a rank of (``set_group``)
        self.group: tp.Optional[DataGroup] = None
        self.clip_loss: tp.Optional[ClipLoss] = clip_loss
        if optim.loss == "clip" and clip_loss is None:
            self.clip_loss = build_clip_loss(args, self.device)
        self.feature_loss: tp.Optional[FeatureDecodingLoss] = None
        if optim.loss == "regression_classification":
            if used_features is None or (optim.use_weighting
                                         and scaler is None):
                raise ValueError(
                    "optim.loss='regression_classification' needs the used "
                    "features, and with optim.use_weighting the scaler")
            self.feature_loss = FeatureDecodingLoss(
                used_features, scaler if optim.use_weighting else None,
                wire_dtype=args.parallel.transfer_dtype)
        #: the pools of past targets each phase samples negatives from
        #: (host arrays, newest first), resolved pool size (2 x negatives
        #: by default; not written back into args, whose delta is the XP
        #: signature) and the sampling RNG
        self.negative_pool: tp.Dict[str, tp.Optional[np.ndarray]] = {
            "train": None, "valid": None}
        n_neg = optim.negatives
        self.negative_pool_size = (
            optim.negative_pool_size if optim.negative_pool_size is not None
            else (2 * n_neg if n_neg else None))
        self._neg_rng = np.random.RandomState(args.seed)

    def _offsets(self) -> tp.Tuple[int, int]:
        args = self.args
        off = int(args.task.offset_meg_ms / 1000 * args.dset.sample_rate)
        return off, off

    def _prompt_limit(self) -> int:
        """The encode task's prompt: the first ``task.meg_init`` s of MEG
        the model sees, which the loss and the metrics leave out (0 when
        decoding)."""
        args = self.args
        if args.task.type == "encode":
            return int(args.task.meg_init * args.dset.sample_rate)
        return 0

    def _task_wiring(self, meg: torch.Tensor, features: torch.Tensor,
                     features_mask: torch.Tensor, train: bool = False):
        """MEG offset, ``task.lowpass`` (a zero-phase FIR of the MEG, 5
        zero crossings a side) and the task's inputs and output: decoding
        reads the MEG into the features; encoding reads the features and
        the MEG prompt (the MEG before ``_prompt_limit``, zeros after) into
        the MEG, lowpassed only with ``task.lowpass_gt`` in training or
        ``task.lowpass_gt_test``. Returns (inputs dict, output, mask)."""
        args = self.args
        if not args.task.mask_loss:
            features_mask = torch.ones_like(features_mask)
        off_meg, off_feat = self._offsets()
        if off_meg:
            meg = meg[..., off_meg:]
            features = features[..., :-off_feat]
            features_mask = features_mask[..., :-off_feat]
        meg_gt = meg
        if args.task.lowpass:
            meg = lowpass_filter(meg, args.task.lowpass
                                 / args.dset.sample_rate, zeros=5)
            if (args.task.lowpass_gt and train) or args.task.lowpass_gt_test:
                meg_gt = meg
        if args.task.type == "decode":
            return dict(meg=meg), features, features_mask
        steps = torch.arange(meg.shape[-1], device=meg.device)
        prompt = (steps < self._prompt_limit()).to(meg.dtype)
        return dict(meg=meg * prompt, features=features), meg_gt, \
            features_mask

    def _forward(self, arrays: tp.Mapping[str, torch.Tensor],
                 pad_weight: torch.Tensor, train: bool = False,
                 norm_arrays: tp.Optional[
                     tp.Mapping[str, torch.Tensor]] = None):
        """Batch arrays (``dataset.to_device``) -> (estimate [B, F, T'] in
        ``simpleconv.output_dtype``, output [B, F, T'], mask [B, 1, T'],
        keep [B] fp32 weights, the merger usage penalty). The encode task
        leaves the prompt's samples out of all three. The model (and the
        feature model, which maps the output) runs in train mode when
        `train` (BatchNorm batch statistics, merger dropout) and in eval
        mode otherwise. `norm_arrays` (the solver's when None) are the
        normalization arrays it reads: ``serve.export_forward`` passes its
        module's buffers."""
        args = self.args
        na = self.norm_arrays if norm_arrays is None else norm_arrays
        meg = arrays["meg"]
        if meg.dtype not in INPUT_TYPES:
            meg = meg.float()
        features = arrays["features"].float()
        rec = arrays["recording_index"]

        # the kernel gathers the recordings' rows and upcasts bf16 itself
        limit_scale = args.norm.max_scale
        meg, peak = normalize_clamp_peak(
            meg, na["meg_center"], na["meg_scale"], limit_scale,
            clip=args.norm.clip, rec=rec)
        features = (features - na["feat_center"][None, :, None]) \
            / na["feat_scale"][None, :, None]
        if args.norm.clip:
            # clamped samples are kept (the post-clamp peak never exceeds
            # the limit)
            keep = torch.ones_like(peak, dtype=torch.bool)
        else:
            keep = peak <= limit_scale
        if args.norm.exclude_empty_features:
            empty = arrays["features_mask"].reshape(
                meg.shape[0], -1).sum(-1) == 0
            keep = keep & ~empty
        keep = keep.float() * pad_weight

        inputs, output, mask = self._task_wiring(
            meg, features, arrays["features_mask"], train)
        self.model.train(train)
        estimate, penalty = self._run_model(inputs, arrays, na)
        limit = self._prompt_limit()
        if limit:
            estimate = estimate[..., limit:]
            output = output[..., limit:]
            mask = mask[..., limit:]
        if self.feature_model is not None:
            # the targets are the feature model's output; in train mode its
            # BatchNorm moves its running statistics
            self.feature_model.train(train)
            output = self.feature_model(output)
            if output.shape[-1] != estimate.shape[-1]:
                # a strided DeepMel shortens the targets, and the JAX
                # package's loss fails on them too
                raise ValueError(
                    f"feature_model_params.stride="
                    f"{self.feature_model.stride}: the feature model's "
                    f"{output.shape[-1]} samples against the estimate's "
                    f"{estimate.shape[-1]}")
        return estimate, output, mask, keep, penalty

    def _run_model(self, inputs: tp.Mapping[str, torch.Tensor],
                   arrays: tp.Mapping[str, torch.Tensor],
                   na: tp.Mapping[str, torch.Tensor]
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """The model on the task's inputs -> (estimate [B, F, T], the
        merger usage penalty). A SimpleConv takes the per-recording arrays
        and the dropout generator, and its [B, T, F] estimate of
        ``output_layout="btc"`` is transposed back here, at the model's
        boundary; any other model (a ConvRNN) takes the generator only and
        has no penalty. `na` are the normalization arrays."""
        if not isinstance(self.model, SimpleConv):
            estimate = self.model(inputs, arrays["subject_index"],
                                  arrays["positions"],
                                  generator=self.generator)
            return estimate, torch.zeros((), device=estimate.device)
        model_kwargs = {}
        if na.get("pos_emb") is not None and self.model.merger_per_subject:
            # per-subject heads attend per sample
            model_kwargs = dict(pos_emb=na["pos_emb"][
                arrays["recording_index"]])
        elif na.get("pos_emb") is not None:
            rec = arrays["recording_index"]
            # per-recording attention: R softmax rows instead of B
            model_kwargs = dict(pos_emb=na["pos_emb"], rec_index=rec,
                                rec_positions=na["rec_positions"])
            if getattr(self.model, "fused_head", False) and \
                    na.get("rec_subjects") is not None:
                # the fused head folds each recording's subject matrix in;
                # this batch's own (recording, subject) pairs override the
                # table, so a batch that gives a recording another subject
                # computes with it, as the unfused subject layers would
                model_kwargs["rec_subjects"] = na["rec_subjects"].long(
                    ).index_put((rec,), arrays["subject_index"])
        estimate, penalty = self.model(
            inputs, arrays["subject_index"], arrays["positions"],
            generator=self.generator, with_penalty=True, **model_kwargs)
        if self.model.output_layout == "btc":
            estimate = estimate.transpose(1, 2)
        return estimate, penalty

    def _output_dim(self, feat_dim: int) -> int:
        """The width of the loss's targets for features of `feat_dim`."""
        if self.feature_model is not None:
            return self.args.feature_model_params.get("n_out_channels",
                                                      feat_dim)
        return feat_dim

    def _loss_value(self, estimate: torch.Tensor, output: torch.Tensor,
                    mask: torch.Tensor, keep: torch.Tensor, train: bool,
                    negatives: tp.Optional[torch.Tensor] = None,
                    negative_weight: tp.Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        if self.clip_loss is not None:
            candidates, weight = output, keep
            if negatives is not None:
                candidates = torch.cat([output, negatives])
                weight = torch.cat([keep, negative_weight])
            return self.clip_loss(estimate, candidates, sample_weight=keep,
                                  candidate_weight=weight, train=train)
        if self.feature_loss is not None:
            return self.feature_loss(estimate, output, mask,
                                     sample_weight=keep, train=train)
        fn = {"l1": masked_l1, "mse": masked_l2}[self.args.optim.loss]
        return fn(estimate, output, mask, sample_weight=keep)

    def _gathered_clip_loss(self, estimate: torch.Tensor,
                            output: torch.Tensor, keep: torch.Tensor,
                            pool: tp.Any, train: bool,
                            negatives: tp.Optional[torch.Tensor] = None,
                            negative_weight: tp.Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """CLIP loss with the rows of this rank's pool of ranks gathered as
        extra candidates (``parallel.gather_rows``), this rank's own block
        among them weighted 0, then the sampled `negatives`, as the JAX
        solver's all_gather branch lays them out."""
        all_out = gather_rows(output, pool)
        all_keep = all_gather(keep.detach(), pool.group)
        other = torch.ones(pool.size, dtype=all_keep.dtype,
                           device=all_keep.device)
        other[pool.position] = 0
        extra_w = (all_keep.view(pool.size, -1) * other[:, None]).reshape(-1)
        candidates, weights = [output, all_out], [keep, extra_w]
        if negatives is not None:
            candidates.append(negatives)
            weights.append(negative_weight)
        return self.clip_loss(estimate, torch.cat(candidates),
                              sample_weight=keep,
                              candidate_weight=torch.cat(weights),
                              train=train)

    def _ring_clip_loss(self, estimate: torch.Tensor, output: torch.Tensor,
                        keep: torch.Tensor, pool: tp.Any, train: bool,
                        negatives: tp.Optional[torch.Tensor] = None,
                        negative_weight: tp.Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """CLIP loss with the other ranks' rows of the pool passed around
        its ring (``parallel.ring_negatives``): each of the k - 1 blocks is
        scored as it arrives, so candidate memory stays at one rank's
        rows; the columns are those of the JAX solver's ring (this rank's
        block, then one block a hop, then the sampled `negatives`), and
        the loss and its gradients equal the gathered layout's."""
        clip = self.clip_loss
        scores = [clip.get_scores(estimate, output, train=train)]
        weights = [keep]
        block, weight = output, keep.detach()
        for _ in range(pool.size - 1):
            block, weight = ring_hop(block, weight, pool)
            scores.append(clip.get_scores(estimate, block, train=train))
            weights.append(weight)
        if negatives is not None:
            scores.append(clip.get_scores(estimate, negatives, train=train))
            weights.append(negative_weight)
        return clip.loss_from_scores(torch.cat(scores, dim=1),
                                     sample_weight=keep,
                                     candidate_weight=torch.cat(weights))

    def _loss_and_aux(self, arrays: tp.Mapping[str, torch.Tensor],
                      pad_weight: torch.Tensor, train: bool,
                      negatives: tp.Optional[torch.Tensor] = None,
                      negative_weight: tp.Optional[torch.Tensor] = None
                      ) -> tp.Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
        """Forward + loss on the batch, this rank's rows under a group,
        whose CLIP candidates then take in the other rows of its pool of
        ``negatives_group_size`` ranks, and the sampled `negatives` (their
        weights `negative_weight`); in training plus the merger penalty
        and ``optim.svd`` times the SVD penalty. Returns (loss, keep
        weights [B], the targets [B, F, T'])."""
        estimate, output, mask, keep, penalty = self._forward(
            arrays, pad_weight, train)
        k = self._negatives_group_size()
        negs = dict(negatives=negatives, negative_weight=negative_weight)
        if self.clip_loss is not None and k > 1:
            pool = self.group.pool(k)
            if self.args.parallel.ring_negatives:
                loss = self._ring_clip_loss(estimate, output, keep, pool,
                                            train, **negs)
            else:
                loss = self._gathered_clip_loss(estimate, output, keep, pool,
                                                train, **negs)
        else:
            loss = self._loss_value(estimate, output, mask, keep, train,
                                    **negs)
        if train:
            loss = loss + penalty
            if self.args.optim.svd:
                # always applied, as the JAX step applies it (_AlwaysApply)
                with record_function("solver.svd_penalty"):
                    loss = loss + self.args.optim.svd * svd_penalty(
                        self.model, rng=_ALWAYS)
        return loss, keep, output

    def _trained_modules(self) -> tp.List[torch.nn.Module]:
        """The modules Adam updates: the model, the feature model and the
        CLIP loss's projection, those that exist."""
        return [m for m in (self.model, self.feature_model, self.clip_loss)
                if m is not None]

    def _synchronize(self, loss: torch.Tensor, keep: torch.Tensor,
                     count: torch.Tensor, grads: bool = False,
                     stats: bool = False) -> tp.Dict[str, torch.Tensor]:
        """{"loss", "keep", "count"} over the group, in one all-reduce
        with, when asked, the gradients and the BatchNorm running
        statistics: the loss, the gradients and the statistics averaged
        over the ranks (the JAX step's pmean), keep and count summed. A
        parameter keeps no gradient when no rank gave it one."""
        if self.group is None:
            return {"loss": loss, "keep": keep, "count": count}
        params = [p for m in self._trained_modules()
                  for p in m.parameters() if p.requires_grad] if grads else []
        buffers = [b for m in self._trained_modules() for mod in m.modules()
                   if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm)
                   and mod.running_mean is not None
                   for b in (mod.running_mean, mod.running_var)] \
            if stats else []
        # one buffer: the scalars, which parameters have a gradient, the
        # gradients (zeros where missing), the statistics
        head = torch.stack([loss.float(), keep.float(), count.float()])
        have = torch.tensor([p.grad is not None for p in params],
                            dtype=torch.float32, device=loss.device)
        parts = [torch.zeros(p.numel(), device=loss.device) if p.grad is None
                 else p.grad.reshape(-1).float() for p in params]
        parts += [b.reshape(-1).float() for b in buffers]
        flat = self.group.all_reduce(torch.cat([head, have, *parts]))
        size = self.group.size
        (loss_sum, keep_sum, count_sum), had, *values = flat.split(
            [3, len(params)] + [t.numel() for t in params + buffers])
        # read back (a sync) only when this rank lacks a gradient
        had = had.tolist() if any(p.grad is None for p in params) \
            else [1.] * len(params)
        for param, value, any_rank in zip(params, values, had):
            value = value.view(param.shape) / size
            if param.grad is not None:
                param.grad.copy_(value)
            elif any_rank > 0:
                param.grad = value.to(param.dtype)
        for buffer, value in zip(buffers, values[len(params):]):
            buffer.copy_(value.view(buffer.shape) / size)
        return {"loss": (loss_sum / size).to(loss.dtype), "keep": keep_sum,
                "count": count_sum}

    @exact_fp32()
    @deterministic_cudnn()
    def loss_and_grad(self, arrays: tp.Mapping[str, torch.Tensor],
                      pad_weight: torch.Tensor, train: bool = True,
                      negatives: tp.Optional[torch.Tensor] = None,
                      negative_weight: tp.Optional[torch.Tensor] = None,
                      return_output: bool = False
                      ) -> tp.Dict[str, torch.Tensor]:
        """Forward (in train mode with `train`), loss and backward, with no
        update: each parameter's ``.grad`` then holds the gradient of the
        loss, under a group of the mean of the ranks' losses, and in
        train mode the BatchNorm running statistics moved (under a group,
        to their mean over the ranks). Returns device scalars {"loss",
        "keep", "count"}, the loss averaged and keep and count summed over
        the ranks, and with `return_output` this rank's targets under
        "output". cuDNN runs deterministic algorithms only
        (``precision.deterministic_cudnn``), so the same step on the same
        card gives the same bits."""
        for module in self._trained_modules():
            module.zero_grad(set_to_none=True)
        loss, keep, output = self._loss_and_aux(
            arrays, pad_weight, train, negatives, negative_weight)
        loss.backward()
        metrics = self._synchronize(loss.detach(), keep.sum(),
                                    pad_weight.sum(), grads=True,
                                    stats=train)
        if return_output:
            metrics["output"] = output.detach()
        return metrics

    @exact_fp32()
    def step(self, arrays: tp.Mapping[str, torch.Tensor],
             pad_weight: torch.Tensor, train: bool,
             negatives: tp.Optional[torch.Tensor] = None,
             negative_weight: tp.Optional[torch.Tensor] = None,
             return_output: bool = False) -> tp.Dict[str, torch.Tensor]:
        """One step on a batch (this rank's rows under a group): with
        `train`, ``loss_and_grad`` in train mode and an optimizer update;
        without, the eval-mode loss and no update. `negatives` [N, F, T']
        and `negative_weight` [N] join the CLIP candidates (the JAX step's
        arguments of the same names). Returns device scalars {"loss",
        "keep", "count"} (over the ranks under a group), and with
        `return_output` this rank's targets [B, F, T'] under "output"
        (the negative pool's update); after a training step each
        parameter's ``.grad`` holds its gradient. All of it runs with TF32
        off (``precision.exact_fp32``)."""
        if train:
            if self.optimizer is None:
                raise ValueError("a training step needs an optimizer")
            metrics = self.loss_and_grad(arrays, pad_weight, True, negatives,
                                         negative_weight, return_output)
            self.optimizer.step()
            return metrics
        with torch.no_grad():
            loss, keep, output = self._loss_and_aux(
                arrays, pad_weight, False, negatives, negative_weight)
        metrics = self._synchronize(loss, keep.sum(), pad_weight.sum())
        if return_output:
            metrics["output"] = output
        return metrics

    # -- ranks ----------------------------------------------------------------

    def set_group(self, group: tp.Optional[DataGroup]) -> None:
        """Train and evaluate as one rank of `group` (``parallel.
        DataGroup``; None: alone), the counterpart of the JAX solver's
        ``set_mesh``. Every rank starts from rank 0's weights and buffers
        (``parallel.replicate``); a step takes this rank's rows of the
        global batch (the loaders of ``from_datasets`` then build only
        those) and averages the loss, the gradients and the BatchNorm
        running statistics over the ranks, each rank's BatchNorm
        normalizing with its own batch statistics as under the JAX
        step's shard_map; the CLIP candidates are the rows of this rank's
        pool of ``negatives_group_size`` ranks, and the sampled negatives
        are the same on every rank (one pool, from every rank's targets);
        ``forward_batch`` splits a batch over the ranks and gives each
        rank all its rows; the dropouts draw on each rank from its own
        stream (``parallel.rank_seed``)."""
        self.group = group
        if group is not None:
            self._negatives_group_size()
            replicate(self._trained_modules(), group)
        for name, loader in getattr(self, "loaders", {}).items():
            if name in ("train", "valid"):
                loader.rows = None if group is None else \
                    group.rows(loader.batch_size)

    def _negatives_group_size(self) -> int:
        """Ranks per CLIP candidate pool: ``negatives_group_size`` with 0
        for all of them, checked against the group (1 alone)."""
        k = self.args.parallel.negatives_group_size
        if self.group is None:
            return 1
        d = self.group.size
        if k == 0:
            return d
        if not (1 <= k <= d and d % k == 0):
            raise ValueError(f"parallel.negatives_group_size={k} must divide "
                             f"the number of ranks {d}")
        return k

    def local_rows(self, n_global: int) -> slice:
        """This rank's row block of a global batch of `n_global` rows (all
        of them alone, or when they do not divide over the ranks)."""
        if self.group is None or n_global % self.group.size:
            return slice(0, n_global)
        return self.group.rows(n_global)

    # -- the epoch loop ------------------------------------------------------

    @classmethod
    def from_datasets(cls, args: tp.Any, datasets: tp.Any,
                      model: torch.nn.Module,
                      optimizer: tp.Optional[torch.optim.Optimizer] = None,
                      generator: tp.Optional[torch.Generator] = None,
                      feature_model: tp.Optional[torch.nn.Module] = None,
                      clip_loss: tp.Optional[ClipLoss] = None
                      ) -> "Solver":
        """The solver of ``train.get_solver``: the scaler fitted on the
        train split's recordings (or read from the disk cache), the
        normalization arrays exported from it for every recording of the
        three splits, the loaders, and the state of the XP folder's
        checkpoint when there is one (else of ``continue_sig``'s). Without
        `optimizer` the model (and `feature_model` and `clip_loss`) keeps
        the best state found."""
        timings: tp.Dict[str, float] = {}
        t0 = time.perf_counter()
        used_features = datasets.train.datasets[0].features
        # the scaler is fitted on DSP-derived features: a numerics change
        # must refit it
        scaler_cache = Cache("scaler", (args.dset, args.norm, DSP_VERSION))

        def fit() -> BatchScaler:
            logger.info("Fitting scaler. Dataset size=%d samples.",
                        len(datasets.train))
            sc = args.norm.scaler
            return BatchScaler(
                used_features,
                n_samples_per_recording=sc.n_samples_per_recording,
                per_channel=sc.per_channel,
                n_samples_features=sc.n_samples_features,
            ).fit(datasets.train.datasets)

        scaler = scaler_cache.get(fit)
        timings["scaler"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        device = next(model.parameters()).device
        norm_arrays = _norm_arrays(scaler, datasets, model)
        solver = cls(args, model,
                     prepare_norm_arrays(model, norm_arrays, device),
                     optimizer=optimizer, generator=generator,
                     feature_model=feature_model,
                     used_features=used_features, scaler=scaler,
                     clip_loss=clip_loss)
        timings["norm_arrays"] = time.perf_counter() - t0
        solver.build_timings = timings
        solver.datasets = datasets
        shuffled = {"train"} | ({"valid"} if args.optim.max_batches
                                else set())
        solver.loaders = {
            name: Loader(getattr(datasets, name),
                         batch_size=args.optim.batch_size,
                         shuffle=name in shuffled, seed=args.seed,
                         drop_last=(name == "train"),
                         num_workers=args.num_workers,
                         assemble_dtype=args.parallel.assemble_dtype,
                         device=device)
            for name in ("train", "valid", "test")}
        solver.history = []
        #: wall seconds of each epoch's stages
        solver.stage_seconds = []
        solver.best_state = None
        solver.best_loss = float("inf")
        solver.best_epoch = 0
        solver.last_test_epoch = 0
        solver.epoch = 1
        solver._rejected = solver._seen = 0
        solver.folder = args.xp_folder
        solver.folder.mkdir(parents=True, exist_ok=True)
        solver.checkpoint_path = solver.folder / tagged("checkpoint.pt")
        wandb = dict(args.wandb)
        solver.metric_sinks = MetricSinks(
            solver.folder, use_wandb=wandb.get("use_wandb", False),
            use_tensorboard=args.tensorboard)
        solver.restore()
        if optimizer is None and solver.best_state is not None:
            solver._load_params(solver.best_state)
        return solver

    def make_loader(self, dataset: tp.Any, shuffle: bool = False,
                    with_events: bool = False) -> Loader:
        """A host loader of fp32 batches: the test stage reads the word
        hashes from the features on the host, where a bf16 rounding would
        change them."""
        return Loader(dataset, batch_size=self.args.optim.batch_size,
                      shuffle=shuffle, seed=self.args.seed,
                      num_workers=self.args.num_workers,
                      with_events=with_events)

    @torch.no_grad()
    @exact_fp32()
    def forward_batch(self, batch: tp.Any,
                      pad_weight: tp.Optional[tp.Any] = None,
                      transfer_dtype: tp.Optional[str] = None):
        """A batch with the ``dataset.ARRAY_FIELDS`` arrays (host arrays or
        tensors) -> (estimate [B, F, T'] in ``simpleconv.output_dtype``,
        output [B, F, T'], mask [B, 1, T'], keep [B] bool), tensors on the
        solver's device, the model in eval mode; meg and features cross in
        `transfer_dtype` (fp32 when None, as the JAX solver's forward
        sends them; only its train and valid steps cross in
        ``parallel.transfer_dtype``). `pad_weight` [B] (ones when None) is
        0 for the rows a loader adds to fill its last batch; those rows
        are not kept."""
        n = len(batch.meg)
        rows = self.local_rows(n)
        split = rows != slice(0, n)
        if split:
            # this rank's rows cross to the card; every rank gets all rows
            batch = types.SimpleNamespace(**{
                name: getattr(batch, name)[rows] for name in ARRAY_FIELDS})
        arrays = to_device(batch, self.device, transfer_dtype)
        if pad_weight is None:
            pad_weight = torch.ones(arrays["meg"].shape[0],
                                    dtype=torch.float32, device=self.device)
        else:
            pad_weight = _on(pad_weight[rows] if split else pad_weight,
                             self.device).float()
        out = self._forward(arrays, pad_weight)[:4]
        if split:
            out = [self.group.all_gather(t) for t in out]
        estimate, output, mask, keep = out
        return estimate, output, mask, keep > 0.5

    def predict(self, meg: tp.Optional[np.ndarray] = None,
                features: tp.Optional[np.ndarray] = None,
                subject_index: int = 0, recording_index: int = 0
                ) -> np.ndarray:
        """The estimate [F, T'] of one item through ``forward_batch`` (eval
        mode), as numpy: `features` [D, T], `meg` [C, T] (zeros of the
        train split's sensor count when None), the positions of the train
        split's first recording and a mask of ones; the batch's
        `subject_index` and `recording_index` as given (under the fused
        head the batch's subject overrides its recording's)."""
        if features is None:
            raise ValueError("predict needs the features")
        n_chan = self.datasets.train[0].meg.shape[0]
        if meg is None:
            meg = np.zeros((n_chan, features.shape[1]), dtype=np.float32)
        positions = self.datasets.train.datasets[0]._get_positions()
        batch = types.SimpleNamespace(
            meg=np.asarray(meg, dtype=np.float32)[None],
            features=np.asarray(features, dtype=np.float32)[None],
            features_mask=np.ones((1, 1, features.shape[-1]), dtype=bool),
            subject_index=np.asarray([subject_index], dtype=np.int32),
            recording_index=np.asarray([recording_index], dtype=np.int32),
            positions=positions[None])
        estimate = self.forward_batch(batch)[0]
        return estimate[0].float().cpu().numpy()

    def _run_one_epoch(self, training: bool) -> tp.Dict[str, float]:
        """One pass of the train or valid loader (at most
        ``optim.max_batches`` batches); the losses stay on the device
        until the epoch's end. The dropout generator is seeded by
        ``dropout_seed``, so that a resumed run draws the disks and masks
        the uninterrupted one would. With ``optim.negatives`` each step
        tops its candidates up from the phase's pool, whose RNG is seeded
        from (seed, epoch, phase), and its targets join the pool. Under a
        group the loaders give this rank's rows (``set_group``)."""
        args = self.args
        phase = "train" if training else "valid"
        loader = self.loaders[phase]
        loader.set_epoch(self.epoch - 1)
        total = len(loader)
        if args.optim.max_batches:
            total = min(total, args.optim.max_batches)
        if self.generator is not None:
            self.generator.manual_seed(self.dropout_seed(training))
        train = training and self.optimizer is not None
        n_neg = args.optim.negatives
        if n_neg is not None:
            # a fresh permutation a batch, seeded per (seed, epoch, phase)
            # only: every rank draws the same negatives
            self._neg_rng = np.random.RandomState(
                (args.seed * 9176 + self.epoch * 2 + int(not training))
                % (2 ** 31))
        losses, keeps, counts = [], [], []
        for idx, (batch, pad_weight) in enumerate(loader):
            if idx >= total:
                break
            arrays = to_device(batch, self.device,
                               args.parallel.transfer_dtype)
            negatives = {}
            if n_neg is not None:
                negatives = dict(zip(
                    ("negatives", "negative_weight"), self._sample_negatives(
                        phase, arrays["features"].shape, n_neg,
                        self._effective_candidates(len(pad_weight)))))
            metrics = self.step(arrays, pad_weight, train, **negatives,
                                return_output=n_neg is not None)
            losses.append(metrics["loss"])
            keeps.append(metrics["keep"])
            counts.append(metrics["count"])
            if n_neg is not None:
                self._update_negative_pool(phase, metrics["output"])
            if idx + 1 == total:
                break
        if not losses:
            return {"loss": float("nan")}
        losses, keeps, counts = torch.stack(
            [torch.stack(losses).float(), torch.stack(keeps).float(),
             torch.stack(counts).float()]).cpu().numpy()
        self._seen += int(counts.sum())
        self._rejected += int(counts.sum() - keeps.sum())
        metrics = {"loss": float(np.mean(losses))}
        if not training and metrics["loss"] < self.best_loss:
            self.best_loss = metrics["loss"]
            self.best_epoch = self.epoch
            logger.info("New best valid loss %.4f", self.best_loss)
            self.best_state = self._copy_params()
        return metrics

    def _effective_candidates(self, local_batch: int) -> int:
        """The in-batch CLIP candidates of this rank before the negatives
        top them up: its `local_batch` rows times the ranks of its pool
        (``negatives_group_size``)."""
        return local_batch * self._negatives_group_size()

    def _sample_negatives(self, phase: str, feat_shape: tp.Sequence[int],
                          n_negatives: int, batch_size: int
                          ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Candidates from `phase`'s pool topping `batch_size` up to
        `n_negatives`: [n_negatives - batch_size, F', T'] and their
        weights on the device, rows past the pool's size zero and weighted
        0 (the JAX solver's static shapes and draws)."""
        n_extra = max(0, n_negatives - batch_size)
        shape = (n_extra, self._output_dim(feat_shape[1]),
                 target_length(self.args, feat_shape[-1]))
        buf = self.negative_pool[phase]
        with record_function("solver.sample_negatives"):
            negatives = np.zeros(shape, dtype=np.float32)
            weight = np.zeros(n_extra, dtype=np.float32)
            if buf is not None and len(buf) and n_extra:
                take = min(n_extra, len(buf))
                sel = self._neg_rng.permutation(len(buf))[:take]
                negatives[:take] = buf[sel]
                weight[:take] = 1.
            return (torch.from_numpy(negatives).to(self.device),
                    torch.from_numpy(weight).to(self.device))

    def _update_negative_pool(self, phase: str,
                              outputs: tp.Union[torch.Tensor, np.ndarray]
                              ) -> None:
        """`phase`'s pool with a step's targets in front, cut to
        ``negative_pool_size``; under a group every rank's rows, gathered
        in rank order (the global batch's), so that every rank keeps the
        same pool. A tensor's rows come to the host (a synchronization)."""
        with record_function("solver.negative_pool"):
            if isinstance(outputs, torch.Tensor):
                if self.group is not None:
                    outputs = self.group.all_gather(outputs)
                outputs = outputs.float().cpu().numpy()
            buf = self.negative_pool[phase]
            buf = outputs if buf is None else np.concatenate([outputs, buf])
            self.negative_pool[phase] = buf[:self.negative_pool_size]

    def dropout_seed(self, training: bool) -> int:
        """The dropout seed for this epoch's train or valid pass:
        from (seed, epoch, phase), and under a group this rank's own
        stream of it (``parallel.rank_seed``)."""
        seed = self.args.seed + self.epoch * 1000 + (0 if training else 1)
        return seed if self.group is None else rank_seed(seed,
                                                         self.group.rank)

    @property
    def lead(self) -> bool:
        """Whether this solver writes the XP folder: alone, or as rank 0
        of its group."""
        return self.group is None or self.group.lead

    def train(self) -> float:
        """Epochs ``self.epoch`` .. ``optim.epochs``: train, valid, and the
        test stage every ``eval_every`` epochs (and at the last) with the
        best state's weights swapped in, when the best state is newer than
        the last test; early stopping after ``early_stop_patience`` epochs
        without a better valid loss; a checkpoint after every epoch, and
        ``done-torch.json`` at the end (the loop never reads it to skip a
        run), written under a group by rank 0 while the others wait.
        Returns the best valid loss."""
        args = self.args
        if self.history:
            logger.info("Replaying %d past epochs of metrics",
                        len(self.history))
        for epoch in range(self.epoch, args.optim.epochs + 1):
            self.epoch = epoch
            stages: tp.Dict[str, tp.Dict[str, float]] = {}
            seconds: tp.Dict[str, float] = {}
            for name, fn in (("train", lambda: self._run_one_epoch(True)),
                             ("valid", lambda: self._run_one_epoch(False))):
                t0 = time.perf_counter()
                stages[name] = fn()
                seconds[name] = time.perf_counter() - t0

            will_stop = epoch == args.optim.epochs
            if args.early_stop_patience and \
                    epoch >= self.best_epoch + args.early_stop_patience:
                logger.warning("Early stopping after %d epochs without "
                               "improvement.", args.early_stop_patience)
                will_stop = True

            if (epoch % args.eval_every == 0 or will_stop) \
                    and self.best_epoch > self.last_test_epoch:
                assert self.best_state is not None
                t0 = time.perf_counter()
                saved = self._copy_params()
                self._load_params(self.best_state)
                try:
                    stages["test"] = self._test_one_epoch()
                finally:
                    self._load_params(saved)
                self.last_test_epoch = epoch
                seconds["test"] = time.perf_counter() - t0
            logger.info(
                "Epoch %d | %s | reject %.3f%% | %s", epoch,
                " | ".join(f"{k} loss {v['loss']:.4f}" if "loss" in v
                           else f"{k} {v}" for k, v in stages.items()),
                100 * self.rejection_rate,
                " ".join(f"{k} {v:.1f}s" for k, v in seconds.items()))
            self.history.append(stages)
            self.stage_seconds.append(seconds)
            self.metric_sinks.log(epoch, stages)
            self.commit()
            if will_stop:
                break
        if self.lead:
            with write_and_rename(self.folder / tagged("done.json"),
                                  "w") as f:
                json.dump({"epochs": self.epoch,
                           "best_loss": float(self.best_loss)}, f)
        if self.group is not None:
            self.group.barrier()
        return self.best_loss

    @property
    def rejection_rate(self) -> float:
        return self._rejected / max(self._seen, 1)

    def _test_one_epoch(self) -> tp.Dict[str, float]:
        """The word-retrieval error (``wer.get_wer``) for a CLIP model whose
        test features carry ``WordHash``, else the streaming metrics of
        ``play.get_test_metrics``; the encode task's leave out the samples
        before ``task.meg_init`` s after the event (the window starts at
        ``dset.tmin``), as the JAX solver's do."""
        test_features = self.datasets.test.datasets[0].features
        if self.clip_loss is not None and "WordHash" in test_features:
            from .wer import get_wer, test_batches
            return get_wer(self, test_batches(self))
        from .play import get_test_metrics
        args = self.args
        trim_offset = 0
        if args.task.type == "encode":
            trim_offset = int(args.dset.sample_rate
                              * (-args.dset.tmin - args.task.meg_init))
        return get_test_metrics(self, trim_offset)

    def get_metric_constructors(self) -> tp.List[tp.Callable]:
        """The encode task's correlation over the MEG channels
        (``corr_meg``); when decoding, a test metric per used feature:
        argmax accuracy for a categorical one, L2 error and correlation
        otherwise."""
        from .metrics import ClassificationAcc, L2Reg, OnlineCorrelation
        if self.args.task.type == "encode":
            return [OnlineCorrelation.get_constructor(
                slice(None), slice(None), "corr_meg")]
        constructors = []
        for feature in self.used_features.values():
            name = feature.name
            sl = self.used_features.get_slice(name)
            out_sl = self.used_features.get_slice(name, model_output=True)
            if feature.categorical:
                constructors.append(ClassificationAcc.get_constructor(
                    out_sl, sl, name=f"acc_{name}"))
            else:
                constructors.append(L2Reg.get_constructor(
                    sl, out_sl, name=f"l2_{name}"))
                constructors.append(OnlineCorrelation.get_constructor(
                    out_sl, sl, name=f"corr_{name}"))
        return constructors

    @property
    def clip(self) -> tp.Optional[ClipLoss]:
        """The CLIP scorer (``wer.get_wer`` reads it as a server's)."""
        return self.clip_loss

    # -- state ----------------------------------------------------------------

    def _prefixed(self) -> tp.Dict[str, tp.Optional[torch.nn.Module]]:
        """The modules of a best state besides the model, by key prefix."""
        return {FM_PREFIX: self.feature_model, LOSS_PREFIX: self.clip_loss}

    def _copy_params(self) -> tp.Dict[str, torch.Tensor]:
        """A copy of the model's state dict (weights and the BatchNorm
        running statistics), the feature model's, its keys after
        ``FM_PREFIX``, and the CLIP loss's projection, its keys after
        ``LOSS_PREFIX``."""
        state = dict(self.model.state_dict())
        for prefix, module in self._prefixed().items():
            if module is not None:
                state.update({prefix + k: v for k, v in
                              module.state_dict().items()})
        return {k: v.detach().clone() for k, v in state.items()}

    def _load_params(self, saved: tp.Mapping[str, torch.Tensor]) -> None:
        prefixes = tuple(self._prefixed())
        self.model.load_state_dict(
            {k: v for k, v in saved.items() if not k.startswith(prefixes)})
        for prefix, module in self._prefixed().items():
            if module is not None:
                module.load_state_dict(
                    {k[len(prefix):]: v for k, v in saved.items()
                     if k.startswith(prefix)})

    def commit(self) -> None:
        """Write the checkpoint (the model's, the feature model's, the CLIP
        loss's and the optimizer's state dicts, the best state, the
        negative pools, the history and the loop's counters) and
        ``history-torch.json``, each through a
        rename. The port writes as the epoch ends (``checkpoint_async`` is
        not read); under a group rank 0 writes while the others wait."""
        if not self.lead:
            self.group.barrier()
            return
        payload = dict(
            model=self.model.state_dict(),
            feature_model=(None if self.feature_model is None
                           else self.feature_model.state_dict()),
            loss=(None if self.clip_loss is None
                  else self.clip_loss.state_dict()),
            optimizer=(None if self.optimizer is None
                       else self.optimizer.state_dict()),
            negative_pool={k: None if v is None else torch.from_numpy(v)
                           for k, v in self.negative_pool.items()},
            best_state=self.best_state, history=list(self.history),
            epoch=self.epoch + 1, best_loss=self.best_loss,
            best_epoch=self.best_epoch,
            last_test_epoch=self.last_test_epoch,
            delta=json.dumps(self.args.delta(), sort_keys=True,
                             default=str))
        with write_and_rename(self.checkpoint_path) as f:
            torch.save(payload, f)
        with write_and_rename(self.folder / tagged("history.json"),
                              "w") as f:
            json.dump(self.history, f, indent=1, default=float)
        if self.group is not None:
            self.group.barrier()

    def _load_checkpoint(self, path: tp.Any) -> tp.Dict[str, tp.Any]:
        with open(path, "rb") as f:
            return torch.load(f, map_location=self.device,
                              weights_only=True)

    def restore(self) -> bool:
        """Resume from this XP's checkpoint. Without one, the JAX package's
        ``checkpoint.pkl`` in the same folder when there is one
        (``_restore_jax``): a training run resumes its whole state, Adam's
        moments included, and a solver without an optimizer (evaluation,
        serving) takes its best weights. Without either, and with
        ``continue_sig``: from that XP's port checkpoint,
        ``continue_best`` loads its best weights, as the JAX package does,
        and otherwise the port resumes its whole training state (weights,
        optimizer, history, counters), so that a run with more
        ``optim.epochs`` continues where the other stopped; from a JAX
        XP's ``checkpoint.pkl`` only, what the JAX package loads: its best
        weights with ``continue_best``, else its current weights and
        batch statistics, and the optimizer starts afresh. Returns
        whether this XP's checkpoint was found."""
        path = self.checkpoint_path
        own = path.exists()
        jax_path = self.folder / JAX_CHECKPOINT
        if not own and jax_path.exists():
            self._restore_jax(jax_path)
            return True
        if not own:
            if not self.args.continue_sig:
                return False
            folder = self.folder.parent / self.args.continue_sig
            path = folder / path.name
            if not path.exists() and (folder / JAX_CHECKPOINT).exists():
                self._continue_jax(folder / JAX_CHECKPOINT)
                return False
            if not path.exists():
                raise FileNotFoundError(f"Could not find checkpoint {path}")
        payload = self._load_checkpoint(path)
        if not own and self.args.continue_best:
            self._load_params(payload["best_state"])
            return False
        self.model.load_state_dict(payload["model"])
        if self.feature_model is not None:
            self.feature_model.load_state_dict(payload["feature_model"])
        if self.clip_loss is not None and payload.get("loss") is not None:
            self.clip_loss.load_state_dict(payload["loss"])
        self.negative_pool = {
            k: None if v is None else v.cpu().numpy() for k, v in payload.get(
                "negative_pool", {"train": None, "valid": None}).items()}
        if self.optimizer is not None and payload["optimizer"] is not None:
            self.optimizer.load_state_dict(payload["optimizer"])
        self.best_state = payload["best_state"]
        self.history = payload["history"]
        self.epoch = payload["epoch"]
        self.best_loss = payload["best_loss"]
        self.best_epoch = payload["best_epoch"]
        self.last_test_epoch = payload["last_test_epoch"]
        logger.info("Restored checkpoint %s at epoch %d", path, self.epoch)
        return own

    def _load_jax_state(self, state: tp.Mapping[str, tp.Any]) -> None:
        """A JAX solver's ``{"params", "batch_stats"}`` trees into the
        model, the feature model and the CLIP loss's projection."""
        load_jax_params(self.model, state["params"], state["batch_stats"],
                        self.feature_model, self.clip_loss)

    def _restore_jax(self, path: tp.Any) -> None:
        """Load the JAX package's ``checkpoint.pkl`` (``convert
        .load_jax_checkpoint``, without jax), with its history, epoch
        counters and negative pools. With an optimizer, its current state
        (``convert.load_jax_params``) and optax's Adam moments
        (``convert.load_jax_optimizer_state``), its best state as the best
        state: training resumes where the JAX run stopped. Without one, its
        best state (its current one when it has none) as the current and
        the best state."""
        payload = load_jax_checkpoint(path)
        best = payload["best_state"]
        if self.optimizer is None:
            self._load_jax_state(best or payload["state"])
            self.best_state = self._copy_params()
        else:
            self.best_state = None
            if best:
                self._load_jax_state(best)
                self.best_state = self._copy_params()
            state = payload["state"]
            self._load_jax_state(state)
            load_jax_optimizer_state(self.optimizer, state["opt_state"],
                                     self.model, self.feature_model,
                                     self.clip_loss)
        self.history = payload["history"]
        self.epoch = payload["epoch"]
        self.best_loss = payload["best_loss"]
        self.best_epoch = payload["best_epoch"]
        self.last_test_epoch = payload["last_test_epoch"]
        self.negative_pool = payload.get("negative_pool",
                                         {"train": None, "valid": None})
        logger.info("Restored the JAX package's checkpoint %s at epoch %d%s",
                    path, self.epoch,
                    "" if self.optimizer is None else " with its Adam state")

    def _continue_jax(self, path: tp.Any) -> None:
        """``continue_sig`` onto a JAX XP: its best state with
        ``continue_best``, else its current weights and batch statistics;
        nothing else (the optimizer starts afresh)."""
        payload = load_jax_checkpoint(path)
        source = payload["best_state" if self.args.continue_best
                         else "state"]
        if not source:
            raise ValueError(f"{path} holds no best state; pass "
                             f"continue_best=False")
        self._load_jax_state(source)


def _norm_arrays(scaler: BatchScaler, datasets: tp.Any,
                 model: torch.nn.Module) -> tp.Dict[str, np.ndarray]:
    """The JAX solver's ``norm_arrays`` and ``_pos_emb_table`` as numpy:
    the scaler's statistics for every recording index of the three
    splits, and with a merger each recording's sensor positions and
    subject (``prepare_norm_arrays`` derives ``pos_emb``)."""
    n_rec = 1 + max(s.recording.recording_index
                    for split in datasets for s in split.datasets)
    n_chan = datasets.train[0].meg.shape[0]
    arrays = scaler.export_arrays(n_rec, n_chan)
    if getattr(model, "merger", None) is not None:
        positions = np.full((n_rec, n_chan, 2), INVALID_POSITION,
                            dtype=np.float32)
        rec_subjects = np.zeros(n_rec, dtype=np.int32)
        for split in datasets:
            for dset in split.datasets:
                index = dset.recording.recording_index
                positions[index] = dset._get_positions()
                rec_subjects[index] = dset.recording.subject_index
        arrays.update(rec_positions=positions, rec_subjects=rec_subjects)
    return arrays
