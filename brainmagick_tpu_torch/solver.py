"""The inference half of the solver: normalize -> task wiring -> model.

Port of ``Solver._offsets``, ``Solver._task_wiring`` and
``Solver._forward(train=False)`` (``brainmagick_tpu/solver.py``); the
per-recording ``pos_emb`` table of ``Solver._pos_emb_table`` is
``models.common.fourier_emb`` of ``rec_positions`` (``serve.Server``).
The normalization arrays keep the JAX solver's ``norm_arrays`` layout:
``meg_center``/``meg_scale`` [R, C],
``feat_center``/``feat_scale`` [F], ``pos_emb`` [R, C, pos_dim],
``rec_positions`` [R, C, 2] and ``rec_subjects`` [R], as tensors on the
model's device.
"""

from __future__ import annotations

import typing as tp

import torch

from .ops.norm import normalize_clamp_peak


class Solver:
    """Inference forward of a decode-task model.

    `args` is a port or JAX ``MainConfig``; options the slice does not
    cover raise NotImplementedError here, at construction."""

    def __init__(self, args: tp.Any, model: torch.nn.Module,
                 norm_arrays: tp.Mapping[str, torch.Tensor]) -> None:
        if args.task.type != "decode":
            raise NotImplementedError(f"task.type={args.task.type!r}")
        if args.task.lowpass:
            raise NotImplementedError(f"task.lowpass={args.task.lowpass!r}")
        if args.feature_model_name is not None:
            raise NotImplementedError(
                f"feature_model_name={args.feature_model_name!r}")
        self.args = args
        self.model = model
        self.norm_arrays = dict(norm_arrays)

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
        """Batch arrays (``dataset.to_device``) -> (estimate [B, F, T'],
        output [B, F, T'], mask [B, 1, T'], keep [B] fp32 weights)."""
        if train:
            raise NotImplementedError("train=True (the port serves only)")
        args = self.args
        na = self.norm_arrays
        meg = arrays["meg"].float()
        features = arrays["features"].float()
        rec = arrays["recording_index"]

        limit_scale = args.norm.max_scale
        meg, peak = normalize_clamp_peak(
            meg, na["meg_center"][rec], na["meg_scale"][rec], limit_scale,
            clip=args.norm.clip)
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
        estimate = self.model(inputs, arrays["subject_index"],
                              arrays["positions"], **model_kwargs)
        return estimate, output, mask, keep
