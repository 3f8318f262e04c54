"""Brain-decoding models (torch, [B, C, T] layout)."""

from __future__ import annotations

import typing as tp

import torch

from . import common  # noqa
from .convrnn import ConvRNN
from .features import DeepMel
from .simpleconv import SimpleConv


def build_model(args: tp.Any, meg_channels: int, out_channels: int,
                n_subjects: int, device: tp.Union[str, torch.device],
                generator: tp.Optional[torch.Generator] = None,
                features_channels: tp.Optional[int] = None
                ) -> tp.Union[SimpleConv, ConvRNN]:
    """Port of ``brainmagick_tpu.train.build_model``: the model
    ``args.model_name`` names (a SimpleConv from ``args.simpleconv`` or a
    ConvRNN from ``args.convrnn``), initialized from `generator` (seed 0
    when None), moved to `device`, in eval mode.

    `out_channels` is the model's target width: the features' output
    dimension in the decode task (with a feature model, the model's output
    width is ``feature_model_params["n_out_channels"]`` instead), the MEG's
    `meg_channels` in the encode task, whose model also reads the features
    (`features_channels` wide) beside the MEG. A `hidden` that is not a
    mapping applies to every input.

    `args` is a ``brainmagick_tpu_torch.config.MainConfig`` or the JAX
    package's ``MainConfig``; only the fields the port reads are used."""
    if args.task.type == "decode":
        in_channels = {"meg": meg_channels}
    elif args.task.type == "encode":
        if features_channels is None:
            raise ValueError("task.type='encode' reads the features: pass "
                             "features_channels")
        in_channels = {"meg": meg_channels, "features": features_channels}
    else:
        raise ValueError(f"Unknown task {args.task.type}")
    if args.feature_model_name is not None and args.task.type == "decode":
        out_channels = args.feature_model_params["n_out_channels"]
    if args.model_name == "simpleconv":
        cls, kw, default_hidden = SimpleConv, dict(args.simpleconv), 320
    elif args.model_name == "convrnn":
        cls, kw, default_hidden = ConvRNN, dict(args.convrnn), 256
    else:
        raise ValueError(f"Invalid model {args.model_name}")
    hidden = kw.pop("hidden", default_hidden)
    if not isinstance(hidden, dict):
        hidden = {name: hidden for name in in_channels}
    model = cls(in_channels=in_channels, out_channels=out_channels,
                hidden=hidden, n_subjects=n_subjects, **kw)
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
