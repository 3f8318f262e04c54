"""The per-batch engine: normalize -> task wiring -> model -> loss, and
the training step.

Port of ``Solver._offsets``, ``Solver._task_wiring``, ``Solver._forward``,
``Solver._loss_value``, ``Solver._loss_and_aux`` and the single-device
step of ``Solver._build_step`` (``brainmagick_tpu/solver.py``), without
the datasets, the epoch loop, sampled negatives or meshes. The
normalization arrays keep the JAX solver's ``norm_arrays`` layout:
``meg_center``/``meg_scale`` [R, C], ``feat_center``/``feat_scale`` [F],
``pos_emb`` [R, C, pos_dim], ``rec_positions`` [R, C, 2] and
``rec_subjects`` [R], as tensors on the model's device
(``prepare_norm_arrays``).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .losses import ClipLoss, masked_l1, masked_l2
from .models.common import fourier_emb
from .ops.norm import INPUT_TYPES, normalize_clamp_peak
from .precision import exact_fp32


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
    ``Solver._pos_emb_table`` does."""
    na = {name: _on(value, device)
          for name, value in norm_arrays.items() if value is not None}
    if model.merger is not None and "pos_emb" not in na:
        na["pos_emb"] = fourier_emb(na["rec_positions"],
                                    model.merger_pos_dim)
    return na


class Solver:
    """Forward, loss and training step of a decode-task model.

    `args` is a port or JAX ``MainConfig``; options the slices do not
    cover raise NotImplementedError here, at construction. `optimizer`
    (``train.build_optimizer``) is needed by a training step only;
    `generator` draws the merger's dropout disk in train mode."""

    def __init__(self, args: tp.Any, model: torch.nn.Module,
                 norm_arrays: tp.Mapping[str, torch.Tensor],
                 optimizer: tp.Optional[torch.optim.Optimizer] = None,
                 generator: tp.Optional[torch.Generator] = None) -> None:
        if args.task.type != "decode":
            raise NotImplementedError(f"task.type={args.task.type!r}")
        if args.task.lowpass:
            raise NotImplementedError(f"task.lowpass={args.task.lowpass!r}")
        if args.feature_model_name is not None:
            raise NotImplementedError(
                f"feature_model_name={args.feature_model_name!r}")
        optim = args.optim
        if optim.loss not in ("clip", "l1", "mse"):
            raise NotImplementedError(f"optim.loss={optim.loss!r}")
        if optim.negatives is not None:
            raise NotImplementedError(
                f"optim.negatives={optim.negatives!r}")
        if optim.svd:
            raise NotImplementedError(f"optim.svd={optim.svd!r}")
        self.args = args
        self.model = model
        self.norm_arrays = dict(norm_arrays)
        self.optimizer = optimizer
        self.generator = generator
        self.clip_loss: tp.Optional[ClipLoss] = None
        if optim.loss == "clip":
            c = args.clip
            self.clip_loss = ClipLoss(
                linear=c.linear, pool=c.pool, center=c.center, tmin=c.tmin,
                tmax=c.tmax, tmin_train=c.tmin_train,
                tmax_train=c.tmax_train, dset_tmin=args.dset.tmin,
                dset_sample_rate=args.dset.sample_rate,
                compute_dtype=c.compute_dtype)

    def _offsets(self) -> tp.Tuple[int, int]:
        args = self.args
        off = int(args.task.offset_meg_ms / 1000 * args.dset.sample_rate)
        return off, off

    def _task_wiring(self, meg: torch.Tensor, features: torch.Tensor,
                     features_mask: torch.Tensor):
        """MEG offset and decode-task input/output selection.
        Returns (inputs dict, output, mask)."""
        if not self.args.task.mask_loss:
            features_mask = torch.ones_like(features_mask)
        off_meg, off_feat = self._offsets()
        if off_meg:
            meg = meg[..., off_meg:]
            features = features[..., :-off_feat]
            features_mask = features_mask[..., :-off_feat]
        return dict(meg=meg), features, features_mask

    def _forward(self, arrays: tp.Mapping[str, torch.Tensor],
                 pad_weight: torch.Tensor, train: bool = False):
        """Batch arrays (``dataset.to_device``) -> (estimate [B, F, T'] in
        ``simpleconv.output_dtype``, output [B, F, T'], mask [B, 1, T'],
        keep [B] fp32 weights, the merger usage penalty). The model runs
        in train mode when `train` (BatchNorm batch statistics, merger
        dropout) and in eval mode otherwise."""
        args = self.args
        na = self.norm_arrays
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
            meg, features, arrays["features_mask"])
        model_kwargs = {}
        if na.get("pos_emb") is not None:
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
        self.model.train(train)
        estimate, penalty = self.model(
            inputs, arrays["subject_index"], arrays["positions"],
            generator=self.generator, with_penalty=True, **model_kwargs)
        return estimate, output, mask, keep, penalty

    def _loss_value(self, estimate: torch.Tensor, output: torch.Tensor,
                    mask: torch.Tensor, keep: torch.Tensor,
                    train: bool) -> torch.Tensor:
        if self.clip_loss is not None:
            return self.clip_loss(estimate, output, sample_weight=keep,
                                  candidate_weight=keep, train=train)
        fn = {"l1": masked_l1, "mse": masked_l2}[self.args.optim.loss]
        return fn(estimate, output, mask, sample_weight=keep)

    def _loss_and_aux(self, arrays: tp.Mapping[str, torch.Tensor],
                      pad_weight: torch.Tensor, train: bool
                      ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Forward + loss (+ the merger penalty in training) on the batch.
        Returns (loss, keep weights [B])."""
        estimate, output, mask, keep, penalty = self._forward(
            arrays, pad_weight, train)
        loss = self._loss_value(estimate, output, mask, keep, train)
        if train:
            loss = loss + penalty
        return loss, keep

    @exact_fp32()
    def step(self, arrays: tp.Mapping[str, torch.Tensor],
             pad_weight: torch.Tensor, train: bool
             ) -> tp.Dict[str, torch.Tensor]:
        """One step on a batch: with `train`, forward in train mode, loss,
        backward and an optimizer update (BatchNorm running statistics
        move during the forward); without, the eval-mode loss and no
        update. Returns device scalars {"loss", "keep", "count"}; after a
        training step each parameter's ``.grad`` holds its gradient. All
        of it runs with TF32 off (``precision.exact_fp32``)."""
        if train:
            if self.optimizer is None:
                raise ValueError("a training step needs an optimizer")
            self.optimizer.zero_grad(set_to_none=True)
            loss, keep = self._loss_and_aux(arrays, pad_weight, True)
            loss.backward()
            self.optimizer.step()
            loss = loss.detach()
        else:
            with torch.no_grad():
                loss, keep = self._loss_and_aux(arrays, pad_weight, False)
        return {"loss": loss, "keep": keep.sum(), "count": pad_weight.sum()}
