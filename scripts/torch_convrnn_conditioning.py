"""How far a ConvRNN train step's fp32 gradients lie from float64's on the
CPU, on the B=8 batch and the attention variant that chip_smoke.py phase
12 holds against the card, and why.

Run from the repository root (about a minute on the CPU, no card):

    python3 scripts/torch_convrnn_conditioning.py

Writes chip_smoke.py's gwilliams2022 tree (208 sensors, two recordings)
into a temporary folder, builds the convrnn preset's datasets over
MelSpectrum on the CPU, and takes chip_smoke.HELD_B rows of the first
train batch through the solver's wiring (normalization, the MEG prompt)
into the inputs of the model that phase 12's attention variant builds
from seeds (attention=1, bidirectional_lstm, flip_lstm, at the preset's
widths). Then the model's L1 loss and its backward in fp32 and in
float64 on the same inputs and weights, and prints: the largest |mean| /
std of a channel at the attention's BatchNorm, the estimate's fp32 error,
the decoder's first-layer ReLU units whose sign the two types disagree
on, and each gradient's largest fp32 error over its largest entry, the
five worst.
"""

from __future__ import annotations

import copy
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from brainmagick_tpu_torch import dataset, train  # noqa: E402
from brainmagick_tpu_torch.env import env  # noqa: E402

ATTENTION = ("convrnn.attention=1", "convrnn.bidirectional_lstm=True",
             "convrnn.flip_lstm=True")


def held_case(work: Path):
    """(model, its inputs, the wired targets, mask, keep, prompt length)
    of phase 12's attention variant on HELD_B rows of the first train
    batch, on the CPU."""
    argv = [*cs.ENCODE_RUNS["encode_convrnn"], *cs.ENCODE_COMMON,
            f"cache={work}/cache_{cs.KEPT_STUDY}",
            f"out_dir={work}/outputs", "device=cpu", *ATTENTION]
    args = train.parse_overrides(argv)
    with env.temporary(studies={cs.KEPT_STUDY: work / cs.KEPT_STUDY},
                       cache=args.cache):
        solver = train.get_solver(args)
    batches = iter(solver.make_loader(solver.datasets.train))
    batch = next(batches)[0]
    batches.close()
    small = types.SimpleNamespace(**{
        name: getattr(batch, name)[:cs.HELD_B]
        for name in dataset.ARRAY_FIELDS})
    n_subjects = 1 + max(d.recording.subject_index
                         for d in solver.datasets.train.datasets)
    trainer = train.Trainer(
        args, 208, 208, n_subjects, None, None, solver.norm_arrays, "cpu",
        generator=torch.Generator().manual_seed(cs.SEED),
        used_features=solver.used_features, scaler=solver.scaler,
        features_channels=120)
    seen = {}
    hook = trainer.model.register_forward_pre_hook(
        lambda module, inputs: seen.update(inputs=inputs))
    with torch.no_grad():
        _, output, mask, keep, _ = trainer.solver._forward(
            dataset.to_device(small, "cpu"), torch.ones(cs.HELD_B),
            train=True)
    hook.remove()
    inputs, subjects = seen["inputs"][:2]
    model = copy.deepcopy(trainer.model)
    return (model, inputs, subjects, output, mask, keep,
            trainer.solver._prompt_limit(), trainer.solver)


def run(case, dtype):
    """The loss's backward in `dtype`: (gradients, the attention BatchNorm's
    input and the decoder's first pre-activation, the estimate)."""
    model, inputs, subjects, output, mask, keep, limit, solver = case
    model = copy.deepcopy(model).to(dtype).train()
    seen = {}
    model.attentions[0].fc.register_forward_hook(
        lambda module, args, out: seen.update(fc=out.detach().double()))
    model.decoder.sequence[0][0].register_forward_hook(
        lambda module, args, out: seen.update(z0=out.detach().double()))
    estimate = model({k: v.to(dtype) for k, v in inputs.items()}, subjects)
    loss = solver._loss_value(estimate[..., limit:], output.to(dtype), mask,
                              keep.to(dtype), True)
    loss.backward()
    grads = {name: p.grad.double() for name, p in model.named_parameters()}
    return grads, seen, estimate.detach().double()


def main() -> None:
    torch.set_num_threads(8)
    with tempfile.TemporaryDirectory(prefix="conditioning_fake_cache_") \
            as tmp:
        work = Path(tmp)
        cs.write_gwilliams_tree(work / cs.KEPT_STUDY,
                                np.random.RandomState(cs.SEED))
        case = held_case(work)
    g32, s32, e32 = run(case, torch.float32)
    g64, s64, e64 = run(case, torch.float64)
    fc = s64["fc"]
    ratio = (fc.mean((0, 2)).abs() / fc.std((0, 2))).max().item()
    flips = int(((s32["z0"] > 0) != (s64["z0"] > 0)).sum())
    errors = sorted(
        ((name, ((g32[name] - g64[name]).abs().max()
                 / g64[name].abs().max()).item()) for name in g64
         # no gradient but noise: the key's bias (the softmax ignores it)
         # and the biases the BatchNorm cancels
         if name not in ("attentions.0.key.bias", "attentions.0.content.bias",
                         "attentions.0.fc.bias")),
        key=lambda item: -item[1])
    print(f"largest |mean| / std at the attention's BatchNorm {ratio:.1f}; "
          f"estimate's fp32 error "
          f"{((e32 - e64).abs().max() / e64.abs().max()).item():.2e}; "
          f"decoder ReLU signs apart {flips} of {s64['z0'].numel()}; "
          f"gradients' fp32 error over their largest entry: "
          + ", ".join(f"{name} {err:.1e}" for name, err in errors[:5]))


if __name__ == "__main__":
    main()
