"""Serving: freeze a trained solver's inference forward and its CLIP
retrieval scorer into ``torch.export`` artifacts, and ``Server``.

Port of ``brainmagick_tpu/serve.py``. ``export_forward`` traces the
solver's eval-mode forward (normalize -> model -> estimate, and the
feature model on the targets) with ``torch.export`` over a symbolic batch
dimension, its parameters, BatchNorm statistics and per-recording
normalization arrays baked in; ``export_scores`` traces the scorer
(estimates [b, F, T'] x candidates [n, F, T'] -> probabilities [b, n],
both dimensions symbolic). The hand-written kernels are registered custom
ops (``torch.ops.brainmagick.normalize_clamp_peak`` and ``nt_matmul``), so
the artifacts keep them: called with CUDA tensors, the forward launches
``csrc/normalize.cu`` and the scorer ``csrc/nt_matmul.cu`` (on the fast
route, ``losses.retrieval_scores``; a trim window, pooling, centering or
the ``clip.linear`` projection scores through ``ClipLoss.get_scores``).

A serving host needs torch and ``brainmagick_tpu_torch.ops``, which
registers the two ops and builds the kernels at their first launch; no
model code, checkpoint, config or data pipeline (where the JAX package's
artifact needs jax alone). This module imports no model code at its top
level, so ``load_exported`` and ``call_exported`` pull none in.

An artifact runs on the device it was exported on; ``load_exported(path,
device="cpu")`` moves it (``torch.export.passes.move_to_device_pass``),
and on the CPU the ops take their plain versions, where the JAX CLI writes
one artifact for two platforms. TF32 is a process flag that an artifact
does not record, so ``call_exported`` runs it inside
``precision.exact_fp32``: the same file gives the same numbers whatever
the caller's flags.

CLI (symbolic batch by default; CLIP solvers also get the scorer as
``<out>_scores.pt2``; the self-check calls the reloaded artifacts at two
batch sizes against the solver):
    python -m brainmagick_tpu_torch.serve sig=<xp_sig> [out=<file>]
        [out_dir=./outputs] [batch_size=N] [scores=true] [selfcheck=true]
        [device=cuda]

``device`` is "cuda" by default, refused at once without a CUDA device;
``device=cpu`` is the only way onto the CPU. ``compilation_cache=`` is
accepted and not read; ``platforms=`` is refused (see ``device=``).

Library:
    exported = serve.export_forward(solver)             # symbolic batch
    serve.save_exported(exported, "model-torch.pt2")
    exported = serve.load_exported("model-torch.pt2")   # serving host
    estimate, output, mask, keep = serve.call_exported(exported, batch)
    scorer = serve.export_scores(solver)
    probs = serve.call_exported(scorer, estimate, candidates)   # [b, n]

``Server`` holds a model, its weights and normalization arrays on one
device and answers both calls eagerly:

    server = Server(args, meg_channels, out_channels, n_subjects,
                    params, batch_stats, norm_arrays, device="cuda")
    estimate, output, mask, keep = server.forward_batch(batch)
    probs = server.probabilities(estimate, candidates)      # [B, N]

On a CUDA device both run the hand-written kernels, and both run with
TF32 off (``precision.exact_fp32``): in fp32, or in the ``clip_conv_tpu``
recipe's bf16 where the config asks for it (the model's compute and
estimate, the scores' operands, the batch's wire format).
"""

from __future__ import annotations

import logging
import sys
import time
import types
import typing as tp
from pathlib import Path

import numpy as np
import torch

from . import tracing
from .precision import exact_fp32
from .utils import as_tensor, transfer, write_and_rename

logger = logging.getLogger(__name__)

#: the exported forward's positional arguments, in order
#: (``dataset.ARRAY_FIELDS``, which a test holds this copy to)
ARG_FIELDS = ("meg", "features", "features_mask", "subject_index",
              "recording_index", "positions")
#: the largest batch of a symbolic-batch forward artifact: on the card,
#: torch 2.11's trace of the forward guards the batch at 65,535 (a CUDA
#: launch's grid limit), and an export over a wider range is refused
MAX_BATCH = 65535
#: forward and probabilities of the self-check against the solver (the
#: JAX CLI's)
FORWARD_TOL = dict(rtol=1e-5, atol=1e-5)
PROBS_TOL = dict(rtol=1e-4, atol=1e-5)


def _probabilities(clip: tp.Any, estimates: torch.Tensor,
                   candidates: torch.Tensor,
                   inv_norms: tp.Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Softmax over candidates of ``losses.retrieval_scores``."""
    from .losses import retrieval_scores
    scores = retrieval_scores(clip, estimates, candidates, inv_norms)
    with tracing.span("softmax"):
        return torch.softmax(scores, dim=1)


class _Forward(torch.nn.Module):
    """``Solver._forward(arrays, ones, train=False)`` over the
    ``ARG_FIELDS`` tensors -> (estimate, output, mask, keep > 0.5); the
    solver's model and feature model are its submodules and the
    normalization arrays its buffers, so ``torch.export`` bakes them in."""

    def __init__(self, solver: tp.Any) -> None:
        super().__init__()
        self.model = solver.model
        self.feature_model = solver.feature_model
        self.norm_names = tuple(solver.norm_arrays)
        for name, value in solver.norm_arrays.items():
            self.register_buffer(f"norm_{name}", value)
        self.solver = solver

    def forward(self, meg: torch.Tensor, features: torch.Tensor,
                features_mask: torch.Tensor, subject_index: torch.Tensor,
                recording_index: torch.Tensor, positions: torch.Tensor):
        arrays = dict(meg=meg, features=features,
                      features_mask=features_mask,
                      subject_index=subject_index.long(),
                      recording_index=recording_index.long(),
                      positions=positions)
        pad_weight = torch.ones(meg.shape[0], dtype=torch.float32,
                                device=meg.device)
        norm_arrays = {name: getattr(self, f"norm_{name}")
                       for name in self.norm_names}
        estimate, output, mask, keep, _ = self.solver._forward(
            arrays, pad_weight, train=False, norm_arrays=norm_arrays)
        return estimate, output, mask, keep > 0.5


class _Scores(torch.nn.Module):
    """(estimates [b, F, T'], candidates [n, F, T']) -> probabilities
    [b, n] of a ``losses.ClipLoss`` (its projection's weights, with
    ``clip.linear``, are its parameters)."""

    def __init__(self, clip: tp.Any) -> None:
        super().__init__()
        self.clip = clip

    def forward(self, estimates: torch.Tensor,
                candidates: torch.Tensor) -> torch.Tensor:
        return _probabilities(self.clip, estimates, candidates)


def _example_split(solver: tp.Any) -> tp.Tuple[str, tp.Any]:
    for split in ("test", "valid", "train"):
        ds = getattr(solver.datasets, split)
        if len(ds):
            return split, ds
    raise ValueError("solver has no data to derive input shapes from")


def prepare_batch(solver: tp.Any, batch: tp.Any,
                  split: str = "test") -> tp.Any:
    """Reduce a dataset batch to the MODEL's feature layout: test splits
    carry extra eval-only channels (e.g. WordHash) that the forward does
    not take (the extraction ``eval.solver_batches`` makes)."""
    features = getattr(solver.datasets, split).datasets[0].features
    used = list(solver.used_features.keys())
    return batch.replace(features=np.asarray(features.extract_features(
        np.asarray(batch.features), used)))


def example_batch(solver: tp.Any, n: int) -> tp.Any:
    """`n` rows of the solver's first non-empty split (test, valid, train;
    cycled when the split is shorter) in the model's feature layout."""
    split, ds = _example_split(solver)
    return prepare_batch(solver, ds.get_batch(np.arange(n) % len(ds)),
                         split=split)


def input_specs(solver: tp.Any, batch_size: tp.Optional[int] = None,
                example: tp.Any = None
                ) -> tp.Tuple[tp.Tuple[torch.Tensor, ...], tp.Any]:
    """(example tensors on the solver's device, in ARG_FIELDS order, each
    in its dataset dtype; ``dynamic_shapes`` for ``torch.export``). The
    rows repeat the first row of `example` (a batch with the ARG_FIELDS
    arrays; the solver's data, ``example_batch``, when None).
    `batch_size=None` makes the batch dimension symbolic (``Dim("b")``,
    1 to MAX_BATCH), so one artifact serves any batch size; the example
    then has 2 rows, since ``torch.export`` specialises a dimension of size
    1. With `batch_size` the artifact takes that batch size only."""
    if example is None:
        example = example_batch(solver, 1)
    rows = batch_size or 2
    tensors = []
    for name in ARG_FIELDS:
        first = as_tensor(getattr(example, name))[:1]
        tensors.append(first.expand(rows, *first.shape[1:]).contiguous()
                       .to(solver.device))
    if batch_size is not None:
        return tuple(tensors), None
    batch = torch.export.Dim("b", min=1, max=MAX_BATCH)
    return tuple(tensors), tuple({0: batch} for _ in ARG_FIELDS)


def export_forward(solver: tp.Any, batch_size: tp.Optional[int] = None,
                   example: tp.Any = None) -> torch.export.ExportedProgram:
    """Export the solver's inference forward (``input_specs`` says what
    `batch_size` and `example` do).

    Signature of the exported function (ARG_FIELDS order):
        (meg [B, C, T], features [B, F, T'], features_mask [B, 1, T'],
         subject_index [B], recording_index [B], positions [B, C, 2])
        -> (estimate, output, mask, keep)

    `features` uses the MODEL's feature layout (reduce raw test-split
    batches with ``prepare_batch`` first). The normalize runs as the
    registered op, so the artifact launches the kernel on the card."""
    inputs, dynamic = input_specs(solver, batch_size, example)
    with torch.no_grad():
        return torch.export.export(_Forward(solver), inputs,
                                   dynamic_shapes=dynamic, strict=False)


def export_scores(solver: tp.Any, example: tp.Any = None
                  ) -> torch.export.ExportedProgram:
    """Export the retrieval scorer, the second half of a deployed
    brain-decoding service:

        (estimates [b, F, T'], candidates [n, F, T']) -> probs [b, n]

    with the solver's CLIP scoring baked in (trim window, norms, the
    projection, pooling and centering); both dimensions are symbolic. It
    takes the forward's (estimate, output) dtypes, traced from a 2-row
    forward of `example` (``input_specs``)."""
    if solver.clip_loss is None:
        raise ValueError("scoring export requires a CLIP solver")
    inputs, _ = input_specs(solver, None, example)
    with torch.no_grad(), exact_fp32():
        estimate, output, _, _ = _Forward(solver)(*inputs)
    rows, candidates = (torch.export.Dim(name, min=1) for name in "bn")
    with torch.no_grad():
        return torch.export.export(
            _Scores(solver.clip_loss), (estimate, output),
            dynamic_shapes=({0: rows}, {0: candidates}), strict=False)


def save_exported(exported: torch.export.ExportedProgram,
                  path: tp.Union[str, Path]) -> Path:
    """Serialize to disk (atomic write)."""
    path = Path(path)
    with write_and_rename(path) as f:
        torch.export.save(exported, f)
    return path


def load_exported(path: tp.Union[str, Path],
                  device: tp.Union[None, str, torch.device] = None
                  ) -> torch.export.ExportedProgram:
    """Deserialize an artifact written by ``save_exported``, its ops
    registered first (``brainmagick_tpu_torch.ops``); with `device`, moved
    there."""
    from . import ops  # noqa: F401  (registers the custom ops)

    exported = torch.export.load(str(path))
    if device is not None:
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, torch.device(device))
    return exported


def _placeholders(module: torch.fx.GraphModule) -> tp.List[tp.Any]:
    return [node for node in module.graph.nodes if node.op == "placeholder"]


def call_exported(exported: tp.Any, *inputs: tp.Any
                  ) -> tp.Union[torch.Tensor, tp.Tuple[torch.Tensor, ...]]:
    """Run an artifact (an ``ExportedProgram``, or the module its
    ``.module()`` gives, which a caller that calls it often keeps) on
    `inputs`: one batch with the forward's ARG_FIELDS arrays, or the
    positional arrays (the scorer's estimates and candidates). Each input
    is cast to the artifact's dtype and moved to its device (a host array
    through page-locked memory, as ``dataset.to_device`` sends a batch);
    the call runs without gradients, with TF32 off (``exact_fp32``)."""
    module = (exported.module()
              if isinstance(exported, torch.export.ExportedProgram)
              else exported)
    specs = [node.meta["val"] for node in _placeholders(module)]
    if len(inputs) == 1 and not isinstance(inputs[0], (torch.Tensor,
                                                       np.ndarray)):
        batch = inputs[0]
        inputs = tuple(getattr(batch, node.name)
                       for node in _placeholders(module))
    if len(inputs) != len(specs):
        raise ValueError(f"the artifact takes {len(specs)} inputs, got "
                         f"{len(inputs)}")
    args = [transfer(x, spec.device, spec.dtype)
            for x, spec in zip(inputs, specs)]
    with torch.no_grad(), exact_fp32():
        return module(*args)


def _check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                 tol: dict) -> None:
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), err_msg=what,
                               **tol)


def selfcheck(solver: tp.Any, forward: tp.Any, scores: tp.Any = None,
              sizes: tp.Sequence[int] = (2, 5)) -> None:
    """The artifacts against the solver on its data at each batch size of
    `sizes`: the forward against ``Solver.forward_batch`` (FORWARD_TOL,
    keep equal), the scorer against the solver's scorer on the solver's
    own estimates and outputs (PROBS_TOL)."""
    for n in sizes:
        batch = example_batch(solver, n)
        est_x, out_x, mask_x, keep_x = call_exported(forward, batch)
        est_s, out_s, mask_s, keep_s = solver.forward_batch(batch)
        _check_close(f"estimate, B={n}", est_x, est_s, FORWARD_TOL)
        _check_close(f"output, B={n}", out_x, out_s, FORWARD_TOL)
        if not (torch.equal(mask_x.cpu(), mask_s.cpu())
                and torch.equal(keep_x.cpu(), keep_s.cpu())):
            raise AssertionError(f"mask or keep differ at B={n}")
        if scores is not None:
            with torch.no_grad(), exact_fp32():
                want = _probabilities(solver.clip_loss, est_s, out_s)
            _check_close(f"probabilities, B={n}",
                         call_exported(scores, est_x, out_x), want,
                         PROBS_TOL)


def main(argv: tp.Optional[tp.Sequence[str]] = None
         ) -> tp.Optional[tp.Dict[str, tp.Any]]:
    """The CLI; returns the artifacts' paths ({"forward", "scores"}, the
    latter None without a scorer) and the export and load seconds."""
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    tokens = dict(t.split("=", 1) for t in
                  (argv if argv is not None else sys.argv[1:]))
    if "sig" not in tokens:
        print(__doc__)
        return None
    if "platforms" in tokens:
        raise ValueError(
            f"platforms={tokens['platforms']}: an artifact of the port runs "
            f"on the device it was exported on; pass device=cuda or "
            f"device=cpu (load_exported(path, device=...) moves one)")
    from .cache import tagged
    from .play import get_solver_from_sig
    from .train import get_device

    device = tokens.get("device", "cuda")
    get_device(types.SimpleNamespace(device=device))
    sig, out_dir = tokens["sig"], tokens.get("out_dir", "./outputs")
    solver = get_solver_from_sig(sig, out_dir=out_dir,
                                 override_args={"device": device},
                                 training=False)
    batch_size = (int(tokens["batch_size"])
                  if "batch_size" in tokens else None)
    seconds: tp.Dict[str, float] = {}
    t0 = time.perf_counter()
    exported = export_forward(solver, batch_size=batch_size)
    seconds["export"] = time.perf_counter() - t0
    out = Path(tokens.get("out", Path(out_dir) / "xps" / sig
                          / tagged("model.pt2")))
    save_exported(exported, out)
    logger.info("Exported %s (batch=%s, %s) -> %s (%.1f MB) in %.1f s", sig,
                batch_size if batch_size is not None else "symbolic",
                solver.device, out, out.stat().st_size / 1e6,
                seconds["export"])

    scores_out = None
    if (tokens.get("scores", "true").lower() != "false"
            and solver.clip_loss is not None):
        t0 = time.perf_counter()
        scorer = export_scores(solver)
        seconds["export_scores"] = time.perf_counter() - t0
        scores_out = out.with_name(out.stem + "_scores" + out.suffix)
        save_exported(scorer, scores_out)
        logger.info("Exported retrieval scorer -> %s (%.1f MB)",
                    scores_out, scores_out.stat().st_size / 1e6)

    if tokens.get("selfcheck", "true").lower() != "false":
        t0 = time.perf_counter()
        reloaded = load_exported(out)
        scores = None if scores_out is None else load_exported(scores_out)
        seconds["load"] = time.perf_counter() - t0
        sizes = (batch_size,) if batch_size is not None else (2, 5)
        selfcheck(solver, reloaded.module(),
                  None if scores is None else scores.module(), sizes)
        logger.info("selfcheck OK: exported forward%s == solver at B=%s",
                    " + scorer" if scores is not None else "",
                    ", ".join(map(str, sizes)))
    return dict(forward=out, scores=scores_out, seconds=seconds)


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
        from .convert import load_jax_params
        from .models import build_model
        from .solver import Solver, prepare_norm_arrays

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
        # (play.get_solver_from_sig, eval by signature, export_scores)
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

    @tracing.span("scoring")
    @torch.no_grad()
    @exact_fp32()
    def probabilities(self, estimates: torch.Tensor,
                      candidates: torch.Tensor,
                      inv_norms: tp.Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Estimates [B, F, T'] against candidates [N, F, T'] -> [B, N]
        softmax over candidates of the CLIP retrieval scores."""
        from .solver import _on

        if self.clip is None:
            raise ValueError("scoring requires a CLIP configuration "
                             "(optim.loss='clip')")
        return _probabilities(self.clip, _on(estimates, self.device),
                              _on(candidates, self.device), inv_norms)


if __name__ == "__main__":
    main()
