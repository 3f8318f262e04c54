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
(``ops.norm.normalize_clamp_peak``, ``ops.matmul.nt_matmul``), and both
run with TF32 off (``precision.exact_fp32``): in fp32, or in the
``clip_conv_tpu`` recipe's bf16 where the config asks for it (the model's
compute and estimate, the scores' operands, the batch's wire format).
"""

from __future__ import annotations

import typing as tp

import torch

from .convert import load_jax_params
from .losses import retrieval_scores
from .models import build_model
from .precision import exact_fp32
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
        if args.feature_model_name is not None:
            # the server scores against candidates the caller brings; the
            # feature model that makes them is the solver's
            raise NotImplementedError(
                f"feature_model_name={args.feature_model_name!r} in Server")
        if args.task.type != "decode":
            # the server decodes MEG into candidates' space; the encode
            # task trains through Solver and Trainer
            raise NotImplementedError(f"task.type={args.task.type!r} in "
                                      f"Server")
        # a training option, and a trained projection the server does not
        # load: such an XP is scored through its solver
        # (play.get_solver_from_sig, eval by signature)
        for name, value in (("optim.negatives", args.optim.negatives),
                            ("clip.linear", args.clip.linear)):
            if value is not None:
                raise NotImplementedError(f"{name}={value!r} in Server")
        self.args = args
        self.device = torch.device(device)
        self.model = build_model(args, meg_channels, out_channels,
                                 n_subjects, self.device, generator)
        if params is not None:
            load_jax_params(self.model, params, batch_stats or {})
        self.solver = Solver(args, self.model, prepare_norm_arrays(
            self.model, norm_arrays, self.device))
        self.clip = self.solver.clip_loss

    def forward_batch(self, batch: tp.Any,
                      pad_weight: tp.Optional[tp.Any] = None):
        """A batch with the ``dataset.ARRAY_FIELDS`` arrays -> (estimate
        [B, F, T'] in ``simpleconv.output_dtype``, output [B, F, T'], mask
        [B, 1, T'], keep [B] bool), tensors on the server's device
        (``Solver.forward_batch``); meg and features cross in
        ``parallel.transfer_dtype``. `pad_weight` [B] (ones when None) is 0
        for the rows a loader adds to fill its last batch; those rows are
        not kept."""
        return self.solver.forward_batch(batch, pad_weight,
                                         self.args.parallel.transfer_dtype)

    @torch.no_grad()
    @exact_fp32()
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
