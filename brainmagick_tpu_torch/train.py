"""Training: config -> datasets -> model -> solver -> epochs.

Port of ``brainmagick_tpu/train.py``: a SimpleConv or a ConvRNN
(``model_name``), decoding the features from the MEG or encoding the MEG
from the features and a MEG prompt (``task.type``). The CLI takes the
JAX package's dotted ``key=value`` overrides (values parsed as
Python literals, ``preset=name`` applies a preset) and trains one XP in
``out_dir/xps/<sig>``, whose signature is the JAX package's for the same
overrides:

    python -m brainmagick_tpu_torch.train preset=clip_conv \
        'dset.selections=["fake"]' 'dset.features=["MelSpectrum"]' \
        optim.epochs=2 cache=./cache/fake_cache

It runs on the CUDA card (``device``, "cuda" by default); ``device=cpu``
is the only way onto the CPU, and without a CUDA device the CLI raises at
once.

On N cards of one host, one rank a card, NCCL between them (gloo with
``device=cpu``):

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m brainmagick_tpu_torch.train preset=clip_conv_v5e8 ...

On H hosts of N cards each, the same command on every host, host h with
``--node_rank=h`` and a static rendezvous at host 0's address, or with
the c10d rendezvous at any reachable host (then the node ranks come from
the rendezvous):

    python -m torch.distributed.run --nnodes=H --node_rank=h \
        --nproc_per_node=N --master_addr=<host 0> --master_port=29500 \
        -m brainmagick_tpu_torch.train ...
    python -m torch.distributed.run --nnodes=H --nproc_per_node=N \
        --rdzv_backend=c10d --rdzv_endpoint=<host>:29400 --rdzv_id=<run> \
        -m brainmagick_tpu_torch.train ...

Every rank draws the same seeded global batch of ``optim.batch_size``
and trains on its block of it (``Solver.set_group``); the batch must
divide over all the ranks. A launch of several ranks always trains as one
run: ``parallel.auto_mesh=false`` is refused there, and no rank falls
back to training alone. ``parallel.distributed_init`` is accepted (the
launcher's environment is always read). Each host's first rank builds the
datasets first (the host's other ranks then read its caches, which need
not be shared between hosts), and rank 0 alone writes the XP folder. A
resume loads the checkpoint on every rank, so on several hosts the XP
folder (``out_dir``) is one folder that every host mounts; the ranks
check that they restored the same epoch. The train step is global on any
number of hosts; the test stage runs per host, as the JAX package's runs
per process, and its metrics are averaged over the hosts.

``Trainer`` is the counterpart of ``get_solver`` for a caller that brings
its own batches:

    trainer = Trainer(args, meg_channels, out_channels, n_subjects,
                      params, batch_stats, norm_arrays, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    # optim.loss='regression_classification' also takes the datasets'
    # used_features= and, with optim.use_weighting, the fitted scaler=;
    # task.type='encode' takes features_channels= and the MEG's width as
    # out_channels; clip.linear takes the targets' length=
    metrics = trainer.step(batch)        # {"loss", "keep", "count", ...}
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import itertools
import json
import logging
import os
import sys
import time
import typing as tp

import torch

from . import dataset as dset
from . import models, ops, parallel
from .config import DELETED, MainConfig, apply_preset
from .convert import load_jax_params
from .dataset import to_device
from .env import env
from .solver import (Solver, build_clip_loss, prepare_norm_arrays,
                     target_length)

logger = logging.getLogger(__name__)


def build_optimizer(args: tp.Any, params: tp.Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """``optim.name='adam'``: the update of ``optax.adam(lr, b1=0.9,
    b2=beta2)`` (eps 1e-8, bias-corrected)."""
    optim = args.optim
    if optim.name != "adam":
        raise ValueError(f"Invalid optimizer {optim.name}")
    return torch.optim.Adam(params, lr=optim.lr, betas=(0.9, optim.beta2),
                            eps=1e-8)


def trained_parameters(model: torch.nn.Module,
                       feature_model: tp.Optional[torch.nn.Module],
                       clip_loss: tp.Optional[torch.nn.Module] = None
                       ) -> tp.Iterator[torch.nn.Parameter]:
    """The parameters Adam updates: the model's, then the feature
    model's, then the CLIP loss's projection (the JAX optimizer's state
    covers ``params["fm"]`` and ``params["loss"]``)."""
    return itertools.chain.from_iterable(
        m.parameters() for m in (model, feature_model, clip_loss)
        if m is not None)


def model_hash(model: torch.nn.Module) -> str:
    """Reproducibility fingerprint of a model's parameters, in
    ``named_parameters`` order and the port's own layouts (so it differs
    from the JAX package's hash of the same weights)."""
    hasher = hashlib.sha1()
    for _, param in model.named_parameters():
        hasher.update(param.detach().float().cpu().numpy().tobytes())
    return hasher.hexdigest()


class Trainer:
    """A model, its Adam optimizer and its solver on one device.

    Arguments as ``serve.Server``'s: `params`/`batch_stats` are the JAX
    solver's trees as numpy (``{"model": ...}``, and ``{"fm": ...}`` for
    the feature model that ``feature_model_name`` asks for, built over
    `out_channels`); with `params` None the models keep the port's own
    initialization, seeded by `generator`, which then draws the merger's
    dropout disks and masks too (seed 0 when None). Adam updates both
    models' parameters and the CLIP loss's projection (``clip.linear``,
    whose input width comes from `length`, the targets' time length, and
    whose weights come from `params`' ``loss`` tree when given).
    `out_channels` and `features_channels` are ``models.build_model``'s.
    `used_features` and `scaler` go to the solver
    (``optim.loss='regression_classification'``)."""

    def __init__(self, args: tp.Any, meg_channels: int, out_channels: int,
                 n_subjects: int, params: tp.Optional[tp.Mapping],
                 batch_stats: tp.Optional[tp.Mapping],
                 norm_arrays: tp.Mapping[str, tp.Any],
                 device: tp.Union[str, torch.device],
                 generator: tp.Optional[torch.Generator] = None,
                 used_features: tp.Any = None,
                 scaler: tp.Any = None,
                 features_channels: tp.Optional[int] = None,
                 length: tp.Optional[int] = None) -> None:
        self.args = args
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.model = models.build_model(args, meg_channels, out_channels,
                                        n_subjects, self.device, generator,
                                        features_channels)
        self.feature_model = models.build_feature_model(
            args, out_channels, self.device, generator)
        self.clip_loss = build_clip_loss(args, self.device, length)
        if params is not None:
            load_jax_params(self.model, params, batch_stats or {},
                            self.feature_model, self.clip_loss)
        self.optimizer = build_optimizer(
            args, trained_parameters(self.model, self.feature_model,
                                     self.clip_loss))
        self.solver = Solver(
            args, self.model,
            prepare_norm_arrays(self.model, norm_arrays, self.device),
            optimizer=self.optimizer, generator=generator,
            feature_model=self.feature_model, used_features=used_features,
            scaler=scaler, clip_loss=self.clip_loss)

    def step(self, batch: tp.Any, train: bool = True,
             negatives: tp.Optional[torch.Tensor] = None,
             negative_weight: tp.Optional[torch.Tensor] = None
             ) -> tp.Dict[str, torch.Tensor]:
        """One step (``Solver.step``) on a batch with the
        ``dataset.ARRAY_FIELDS`` arrays, every row weighted 1, with the
        extra CLIP candidates `negatives` (weights `negative_weight`) when
        given; meg and features cross in ``parallel.transfer_dtype``."""
        arrays = to_device(batch, self.device,
                           self.args.parallel.transfer_dtype)
        pad_weight = torch.ones(arrays["meg"].shape[0], dtype=torch.float32,
                                device=self.device)
        return self.solver.step(arrays, pad_weight, train, negatives,
                                negative_weight)


def get_device(args: tp.Any) -> torch.device:
    """``args.device``: "cuda" (the default), refused when no CUDA device
    is visible, or "cpu". Under a launcher, "cuda" is this rank's card,
    ``cuda:LOCAL_RANK``."""
    try:
        device = torch.device(args.device)
    except RuntimeError:
        device = None
    if device is None or device.type not in ("cuda", "cpu"):
        raise ValueError(f"device={args.device!r}: 'cuda' or 'cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={args.device!r} but no CUDA device is visible; "
            f"pass device=cpu to run on the CPU")
    if device.type == "cuda" and device.index is None \
            and parallel.launched():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def join_launcher(args: tp.Any, check_batch: bool = True
                  ) -> tp.Optional[parallel.DataGroup]:
    """Under ``python -m torch.distributed.run``: this process joins the
    launcher's ranks on its device (``parallel.init_distributed``: its
    own card over NCCL, or the CPU over gloo) and the run's
    ``DataGroup`` is returned, with the hosts of a launch over several
    nodes; without a launcher, None. With several ranks,
    ``parallel.auto_mesh=false`` and (`check_batch`) an
    ``optim.batch_size`` that does not divide over all of them raise: the
    launcher started one run."""
    if not parallel.launched():
        return None
    world = int(os.environ["WORLD_SIZE"])
    if not args.parallel.auto_mesh:
        if world > 1:
            raise ValueError(
                f"parallel.auto_mesh=false under a launcher of {world} "
                f"ranks: each rank would train the whole batch alone")
        return None
    if check_batch and args.optim.batch_size % world:
        raise ValueError(
            f"auto_mesh: batch_size {args.optim.batch_size} does not divide "
            f"over {world} devices. Set a divisible optim.batch_size or "
            f"launch another number of ranks.")
    parallel.init_distributed(get_device(args))
    return parallel.DataGroup()


def build_datasets(args: tp.Any) -> dset.Datasets:
    """The splits of ``args.dset`` (``WordHash`` added to the test
    features of a CLIP loss, for the word-retrieval test stage), the
    recordings preprocessed on ``args.device``."""
    kwargs = dataclasses.asdict(args.dset)
    kwargs["selections"] = [args.selections[name]
                            for name in kwargs.pop("selections")]
    if args.optim.loss == "clip":
        kwargs["extra_test_features"] = list(
            kwargs.get("extra_test_features") or []) + ["WordHash"]
    return dset.get_datasets(num_workers=args.num_workers,
                             device=get_device(args), **kwargs)


def model_widths(args: tp.Any, datasets: dset.Datasets
                 ) -> tp.Tuple[int, int, tp.Optional[int]]:
    """(the train split's sensor count, the model's target width, the
    features' input width or None): decoding targets the features' model
    outputs; encoding targets the MEG and reads the features."""
    meg_dimension = datasets.train[0].meg.shape[0]
    features = datasets.train.datasets[0].features
    if args.task.type == "encode":
        return meg_dimension, meg_dimension, features.dimension
    return meg_dimension, features.output_dimension, None


def build_model(args: tp.Any, datasets: dset.Datasets,
                device: tp.Union[str, torch.device],
                generator: tp.Optional[torch.Generator] = None
                ) -> torch.nn.Module:
    """``models.build_model`` at the widths of `datasets`
    (``model_widths``; the feature model's output width when there is one
    in the decode task), one subject layer per train subject
    (``override_n_subjects_model`` when set)."""
    meg_dimension, chout, features_dimension = model_widths(args, datasets)
    if args.override_n_subjects_model is not None:
        n_subjects = args.override_n_subjects_model
    else:
        n_subjects = 1 + max(d.recording.subject_index
                             for d in datasets.train.datasets)
    return models.build_model(args, meg_dimension, chout, n_subjects,
                              device, generator, features_dimension)


def get_solver(args: tp.Any, training: bool = True,
               group: tp.Optional[parallel.DataGroup] = None) -> Solver:
    """Datasets, model, feature model and CLIP loss (each initialized
    from a generator seeded with ``seed``), Adam over them when
    `training`, and
    the dataset-driven solver (``Solver.from_datasets``); with `group`
    (``join_launcher``), built on each host's first rank and then on the
    host's other ranks (``parallel.lead_first``), and a rank of that group
    (``Solver.set_group``)."""
    device = get_device(args)
    with parallel.lead_first(group):
        t0 = time.perf_counter()
        datasets = build_datasets(args)
        t_datasets = time.perf_counter() - t0
        if args.download_only:
            sys.exit(0)
        model = build_model(args, datasets, device,
                            torch.Generator().manual_seed(args.seed))
        feature_model = models.build_feature_model(
            args, model_widths(args, datasets)[1], device,
            torch.Generator().manual_seed(args.seed))
        clip_loss = build_clip_loss(args, device, target_length(
            args, datasets.train[0].features.shape[-1]))
        optimizer = build_optimizer(
            args, trained_parameters(model, feature_model, clip_loss)) \
            if training else None
        solver = Solver.from_datasets(
            args, datasets, model, optimizer,
            generator=torch.Generator(device=device).manual_seed(args.seed),
            feature_model=feature_model, clip_loss=clip_loss)
    solver.build_timings["datasets"] = t_datasets
    if group is not None:
        solver.set_group(group)
    return solver


def run(args: tp.Any) -> float:
    """Train one XP, with the config's cache folder in the env."""
    with env.temporary_from_args(args):
        return _run(args)


def _run(args: tp.Any) -> float:
    group = join_launcher(args)
    level = logging.DEBUG if args.verbose else logging.INFO
    rank = "" if group is None else f"[rank {group.rank}] "
    logging.basicConfig(level=level,
                        format=f"%(levelname)s {rank}%(name)s: %(message)s")
    solver = get_solver(args, group=group)
    if group is not None:
        logger.info("Data-parallel run over %d rank(s) (%s) on %d host(s); "
                    "contrastive negative groups of %d", group.size,
                    group.backend, group.n_hosts,
                    solver._negatives_group_size())
    logger.info("Model hash: %s", model_hash(solver.model))
    if args.show:
        n_params = sum(p.numel() for p in solver.model.parameters())
        logger.info("Size: %.1f MB", n_params * 4 / 2 ** 20)
        return 0.0
    best = solver.train()
    logger.info("Program counters: %s", json.dumps(ops.launch_counts()))
    return best


def parse_overrides(argv: tp.Sequence[str],
                    args: tp.Optional[MainConfig] = None) -> MainConfig:
    """``a.b.c=value`` overrides (values parsed as Python literals, else
    kept as strings; ``preset=name`` applies a preset) onto `args`."""
    args = args or MainConfig()
    for token in argv:
        if "=" not in token:
            raise ValueError(f"Expected key=value, got {token!r}")
        key, raw = token.split("=", 1)
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        if key == "preset":
            apply_preset(args, value)
            continue
        target: tp.Any = args
        parts = key.split(".")
        for part in parts[:-1]:
            target = target[part] if isinstance(target, dict) \
                else getattr(target, part)
        last = parts[-1]
        if isinstance(target, dict):
            if value == DELETED:
                target.pop(last, None)
            else:
                target[last] = value
        else:
            if not hasattr(target, last):
                raise ValueError(f"Unknown config key {key!r}")
            setattr(target, last, value)
    return args


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> float:
    """The CLI: train the XP of the overrides `argv` (``sys.argv[1:]``
    when None); returns its best valid loss."""
    args = parse_overrides(argv if argv is not None else sys.argv[1:])
    get_device(args)
    logger.info("XP signature: %s -> %s", args.sig, args.xp_folder)
    return run(args)


if __name__ == "__main__":
    main()
