"""Brain-decoding models (torch, [B, C, T] layout)."""

from __future__ import annotations

import typing as tp

import torch

from . import common  # noqa
from .simpleconv import SimpleConv


def build_model(args: tp.Any, meg_channels: int, out_channels: int,
                n_subjects: int, device: tp.Union[str, torch.device],
                generator: tp.Optional[torch.Generator] = None
                ) -> SimpleConv:
    """Port of ``brainmagick_tpu.train.build_model`` for the decode task:
    a SimpleConv from ``args.simpleconv``, initialized from `generator`
    (seed 0 when None), moved to `device`, in eval mode.

    `args` is a ``brainmagick_tpu_torch.config.MainConfig`` or the JAX
    package's ``MainConfig``; only the fields the slice reads are used."""
    if args.model_name != "simpleconv":
        raise NotImplementedError(f"model_name={args.model_name!r}")
    if args.task.type != "decode":
        raise NotImplementedError(f"task.type={args.task.type!r}")
    if args.feature_model_name is not None:
        raise NotImplementedError(
            f"feature_model_name={args.feature_model_name!r}")
    kw = dict(args.simpleconv)
    hidden = kw.pop("hidden", 320)
    if not isinstance(hidden, dict):
        hidden = {"meg": hidden}
    model = SimpleConv(in_channels={"meg": meg_channels},
                       out_channels=out_channels, hidden=hidden,
                       n_subjects=n_subjects, **kw)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.to(device).eval()
