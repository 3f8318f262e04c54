"""The system under test: ``brainmagick_tpu_torch``'s ``train.Trainer``
and ``serve.Server`` built from a configuration's presets and overrides,
their port-initialized weights replaced by the run's seeded ones. This is
the program entry of every configuration that names none
(``spec.program_entry``). It and the entries under
``benchmark/programs/`` are the only modules of the benchmark that import
the program; each loads its seeded weights through ``load``."""

from __future__ import annotations

import typing as tp

import torch

Tensors = tp.Dict[str, torch.Tensor]


def port_args(config: dict) -> tp.Any:
    """The program's ``MainConfig``: each preset of ``config["preset"]``
    in order, then each dotted override of ``config["overrides"]``."""
    from brainmagick_tpu_torch.config import MainConfig, apply_preset
    from brainmagick_tpu_torch.train import parse_overrides

    args = MainConfig()
    for name in config["preset"]:
        apply_preset(args, name)
    return parse_overrides([f"{k}={v!r}" for k, v in
                            config.get("overrides", {}).items()], args)


def load(module: torch.nn.Module, params: Tensors, stats: Tensors,
         prefix: str = "") -> None:
    """`module`'s state from the seeded `params` and `stats` (names under
    `prefix`): every parameter and running statistic must be given, and
    nothing else, each in the program's shape; BatchNorm's step counters
    are kept."""
    state = module.state_dict()
    given = {k[len(prefix):]: v for k, v in {**params, **stats}.items()
             if k.startswith(prefix) and (prefix or not k.startswith("fm."))}
    counters = {k for k in state if k.endswith("num_batches_tracked")}
    missing = set(state) - set(given) - counters
    extra = set(given) - set(state)
    if missing or extra:
        raise KeyError(f"seeded weights and the program's differ: missing "
                       f"{sorted(missing)}, unknown {sorted(extra)}")
    for name, value in given.items():
        if tuple(state[name].shape) != tuple(value.shape):
            raise ValueError(f"{prefix}{name}: the program's "
                             f"{tuple(state[name].shape)}, seeded "
                             f"{tuple(value.shape)}")
    module.load_state_dict({**{k: state[k] for k in counters}, **given})


def trainer(config: dict, params: Tensors, stats: Tensors, norm: Tensors,
            device: torch.device, dropout_seed: int) -> tp.Any:
    """The program's training step, weights seeded; its dropout generator
    is re-seeded with `dropout_seed` once built, so that the draws of the
    steps are known."""
    from brainmagick_tpu_torch.train import Trainer

    m = config["model"]
    gen = torch.Generator()
    out = Trainer(port_args(config), m["sensors"], m["features"],
                  m["subjects"], None, None, norm, device, generator=gen)
    load(out.model, params, stats)
    if out.feature_model is not None:
        load(out.feature_model, params, stats, "fm.")
    gen.manual_seed(dropout_seed)
    return out


def server(config: dict, params: Tensors, stats: Tensors, norm: Tensors,
           device: torch.device) -> tp.Any:
    """The program's server, weights and running statistics seeded."""
    from brainmagick_tpu_torch.serve import Server

    m = config["model"]
    out = Server(port_args(config), m["sensors"], m["features"],
                 m["subjects"], None, None, norm, device)
    load(out.model, params, stats)
    return out


def trained_leaves(tr: tp.Any) -> tp.Dict[str, torch.nn.Parameter]:
    """The parameters the trainer's Adam updates, by the seeded names."""
    leaves = dict(tr.model.named_parameters())
    if tr.feature_model is not None:
        leaves.update({f"fm.{k}": v for k, v in
                       tr.feature_model.named_parameters()})
    return leaves


def launch_counts() -> tp.Dict[str, int]:
    from brainmagick_tpu_torch import ops

    return dict(ops.launch_counts())
