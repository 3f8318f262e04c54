"""Training on one device: model, optimizer and solver from the config.

Port of ``brainmagick_tpu/train.py`` without the datasets: the epoch loop
(``Solver.train``) needs the data path, which is not ported yet.
``Trainer`` is the counterpart of ``get_solver`` for a caller that brings
its own batches:

    trainer = Trainer(args, meg_channels, out_channels, n_subjects,
                      params, batch_stats, norm_arrays, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    metrics = trainer.step(batch)        # {"loss", "keep", "count"}
"""

from __future__ import annotations

import hashlib
import typing as tp

import torch

from .convert import load_jax_params
from .dataset import to_device
from .models import build_model
from .solver import Solver, prepare_norm_arrays


def build_optimizer(args: tp.Any, params: tp.Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """``optim.name='adam'``: the update of ``optax.adam(lr, b1=0.9,
    b2=beta2)`` (eps 1e-8, bias-corrected)."""
    optim = args.optim
    if optim.name != "adam":
        raise ValueError(f"Invalid optimizer {optim.name}")
    return torch.optim.Adam(params, lr=optim.lr, betas=(0.9, optim.beta2),
                            eps=1e-8)


def model_hash(model: torch.nn.Module) -> str:
    """Reproducibility fingerprint of a model's parameters, in
    ``named_parameters`` order and the port's own layouts (so it differs
    from the JAX package's hash of the same weights)."""
    hasher = hashlib.sha1()
    for _, param in model.named_parameters():
        hasher.update(param.detach().float().cpu().numpy().tobytes())
    return hasher.hexdigest()


class Trainer:
    """A decode model, its Adam optimizer and its solver on one device.

    Arguments as ``serve.Server``'s: `params`/`batch_stats` are the JAX
    solver's trees as numpy (``{"model": ...}``); with `params` None the
    model keeps the port's own initialization, seeded by `generator`,
    which then draws the merger's dropout disks too (seed 0 when None)."""

    def __init__(self, args: tp.Any, meg_channels: int, out_channels: int,
                 n_subjects: int, params: tp.Optional[tp.Mapping],
                 batch_stats: tp.Optional[tp.Mapping],
                 norm_arrays: tp.Mapping[str, tp.Any],
                 device: tp.Union[str, torch.device],
                 generator: tp.Optional[torch.Generator] = None) -> None:
        self.args = args
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.model = build_model(args, meg_channels, out_channels,
                                 n_subjects, self.device, generator)
        if params is not None:
            load_jax_params(self.model, params, batch_stats or {})
        self.optimizer = build_optimizer(args, self.model.parameters())
        self.solver = Solver(
            args, self.model,
            prepare_norm_arrays(self.model, norm_arrays, self.device),
            optimizer=self.optimizer, generator=generator)

    def step(self, batch: tp.Any, train: bool = True
             ) -> tp.Dict[str, torch.Tensor]:
        """One step (``Solver.step``) on a batch with the
        ``dataset.ARRAY_FIELDS`` arrays, every row weighted 1; meg and
        features cross in ``parallel.transfer_dtype``."""
        arrays = to_device(batch, self.device,
                           self.args.parallel.transfer_dtype)
        pad_weight = torch.ones(arrays["meg"].shape[0], dtype=torch.float32,
                                device=self.device)
        return self.solver.step(arrays, pad_weight, train)
