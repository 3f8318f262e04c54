"""Serving: a decode model's forward and its CLIP retrieval scorer.

Port of ``brainmagick_tpu/serve.py``. Where the JAX package exports the
solver's forward (``export_forward``) and the scorer (``export_scores``)
as artifacts, ``Server`` holds the model, weights and normalization
arrays on one device and answers both calls directly:

    server = Server(args, meg_channels, out_channels, n_subjects,
                    params, batch_stats, norm_arrays, device="cuda")
    estimate, output, mask, keep = server.forward_batch(batch)
    probs = server.probabilities(estimate, candidates)      # [B, N]

On a CUDA device both calls run the hand-written kernels
(``ops.norm.normalize_clamp_peak``, ``ops.matmul.nt_matmul``).
"""

from __future__ import annotations

import typing as tp

import torch

from .convert import load_jax_params
from .dataset import to_device
from .losses import retrieval_scores
from .models import build_model
from .solver import Solver, _on, prepare_norm_arrays


class Server:
    """Inference on one device.

    `params`/`batch_stats` are the JAX solver's trees as numpy
    (``{"model": ...}``); with `params` None the model keeps the port's
    own initialization, seeded by `generator`. `norm_arrays` follows the
    JAX solver's layout (numpy or tensors); ``pos_emb`` is computed from
    ``rec_positions`` when absent."""

    def __init__(self, args: tp.Any, meg_channels: int, out_channels: int,
                 n_subjects: int, params: tp.Optional[tp.Mapping],
                 batch_stats: tp.Optional[tp.Mapping],
                 norm_arrays: tp.Mapping[str, tp.Any],
                 device: tp.Union[str, torch.device],
                 generator: tp.Optional[torch.Generator] = None) -> None:
        self.device = torch.device(device)
        self.model = build_model(args, meg_channels, out_channels,
                                 n_subjects, self.device, generator)
        if params is not None:
            load_jax_params(self.model, params, batch_stats or {})
        self.solver = Solver(args, self.model, prepare_norm_arrays(
            self.model, norm_arrays, self.device))
        self.clip = self.solver.clip_loss

    @torch.no_grad()
    def forward_batch(self, batch: tp.Any):
        """A batch with the ``dataset.ARRAY_FIELDS`` arrays -> (estimate
        [B, F, T'], output [B, F, T'], mask [B, 1, T'], keep [B] bool),
        tensors on the server's device."""
        arrays = to_device(batch, self.device)
        pad_weight = torch.ones(arrays["meg"].shape[0], dtype=torch.float32,
                                device=self.device)
        estimate, output, mask, keep, _ = self.solver._forward(arrays,
                                                               pad_weight)
        return estimate, output, mask, keep > 0.5

    @torch.no_grad()
    def probabilities(self, estimates: torch.Tensor,
                      candidates: torch.Tensor,
                      inv_norms: tp.Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Estimates [B, F, T'] against candidates [N, F, T'] -> [B, N]
        softmax over candidates of the CLIP retrieval scores."""
        if self.clip is None:
            raise ValueError("scoring requires a CLIP configuration "
                             "(optim.loss='clip')")
        estimates = _on(estimates, self.device)
        candidates = _on(candidates, self.device)
        scores = retrieval_scores(self.clip, estimates, candidates,
                                  inv_norms)
        return torch.softmax(scores, dim=1)
