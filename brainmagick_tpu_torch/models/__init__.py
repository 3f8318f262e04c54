"""Brain-decoding models (torch, [B, C, T] layout)."""

from __future__ import annotations

import typing as tp

import torch

from . import common  # noqa
from .features import DeepMel
from .simpleconv import SimpleConv


def build_model(args: tp.Any, meg_channels: int, out_channels: int,
                n_subjects: int, device: tp.Union[str, torch.device],
                generator: tp.Optional[torch.Generator] = None
                ) -> SimpleConv:
    """Port of ``brainmagick_tpu.train.build_model`` for the decode task:
    a SimpleConv from ``args.simpleconv``, initialized from `generator`
    (seed 0 when None), moved to `device`, in eval mode. `out_channels`
    is the features' output dimension; with a feature model the model's
    output width is ``feature_model_params["n_out_channels"]`` instead.

    `args` is a ``brainmagick_tpu_torch.config.MainConfig`` or the JAX
    package's ``MainConfig``; only the fields the slice reads are used."""
    if args.model_name != "simpleconv":
        raise NotImplementedError(f"model_name={args.model_name!r}")
    if args.task.type != "decode":
        raise NotImplementedError(f"task.type={args.task.type!r}")
    if args.feature_model_name is not None:
        out_channels = args.feature_model_params["n_out_channels"]
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


def build_feature_model(args: tp.Any, out_channels: int,
                        device: tp.Union[str, torch.device],
                        generator: tp.Optional[torch.Generator] = None
                        ) -> tp.Optional[DeepMel]:
    """The feature model ``args.feature_model_name`` names over the
    features' `out_channels` (None when it names none), as the JAX
    package's ``build_model`` makes it: ``DeepMel(n_in_channels=
    out_channels, **feature_model_params)`` without ``device``,
    initialized from `generator` (seed 0 when None), moved to `device`,
    in eval mode."""
    name = args.feature_model_name
    if name is None:
        return None
    if name != "deep_mel":
        raise ValueError(f"Invalid feature model {name}")
    params = dict(args.feature_model_params)
    params.pop("device", None)
    feature_model = DeepMel(n_in_channels=out_channels, **params)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    feature_model.reset_parameters(generator)
    return feature_model.to(device).eval()
