"""How far apart two runs of one train step land, option by option: the
clip_conv_tpu recipe with its compute in fp32 (chip_smoke.py phase 16's
held step) at the paper's width, B=8, from seeds, with each of the train
step's options of phase 16 alone and all together.

For each option set it prints each parameter's gradient error (max
|diff| over max |reference|) of the card against the CPU at 8 threads,
and for the base, all options, and all options but the rewrite conv, the
CPU at 1 thread against the CPU at 8 threads: two summation orders on one
machine. The rewrite conv's ReLU (``relu_leakiness`` 0) flips where its
input lies within rounding of 0, so that its gradient steps wherever two
runs round apart; the last block runs the all-options step in float64
(the fused layers unfused) on both devices.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/torch_options_conditioning.py

It needs about a minute (the kernels' build included).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from brainmagick_tpu_torch.config import MainConfig, apply_preset  # noqa
from brainmagick_tpu_torch.ops import _build  # noqa: E402

N_NEGATIVES = 64
DROPOUTS = dict(conv_dropout=0.1, dropout_input=0.1, dropout=0.1)
LAYER = dict(rewrite=True, scale=0.1, post_skip=True)
EVERYTHING = {**DROPOUTS, **LAYER, "output_layout": "btc"}
#: name: (simpleconv options, optim options)
VARIANTS = {
    "base": ({}, {}), "svd": ({}, {"svd": 0.01}),
    "negatives": ({}, {"negatives": N_NEGATIVES}),
    "channel_dropout": (dict(dropout=0.1), {}),
    "dropout_input": (dict(dropout_input=0.1), {}),
    "conv_dropout": (dict(conv_dropout=0.1), {}),
    "rewrite": (dict(rewrite=True), {}),
    "scale_post_skip": (dict(scale=0.1, post_skip=True), {}),
    "btc": (dict(output_layout="btc"), {}),
    "all": (EVERYTHING, {"svd": 0.01, "negatives": N_NEGATIVES}),
    "all_but_rewrite": ({**EVERYTHING, "rewrite": False},
                        {"svd": 0.01, "negatives": N_NEGATIVES})}
#: the variants also run on the CPU at 1 thread
SPREAD = ("base", "all", "all_but_rewrite")


def held(where, simpleconv: dict, optim: dict, batch, negatives,
         float64: bool = False):
    """chip_smoke.py's held step (``_options_held_step``) on seeded
    normalization arrays: (loss, model)."""
    args = apply_preset(MainConfig(), cs.RECIPE)
    args.simpleconv.update(fused_conv_bn=True, dtype=None, output_dtype=None,
                           **simpleconv)
    args.clip.compute_dtype = None
    for key, value in optim.items():
        setattr(args.optim, key, value)
    norm_arrays, _ = cs.seeded_arrays()
    if "negatives" not in optim:
        negatives = (negatives[0][:0], negatives[1][:0])
    return cs._options_held_step(where, args, (cs.C, cs.F, cs.N_SUBJECTS),
                                 norm_arrays, batch, negatives, float64)


def errors(run, reference) -> dict:
    """The loss's relative error and each parameter's gradient error."""
    (loss, model), (loss_ref, model_ref) = run, reference
    out = {"loss": abs(loss - loss_ref) / abs(loss_ref)}
    grads = dict(model_ref.named_parameters())
    for name, param in model.named_parameters():
        if param.grad is not None:
            ref = grads[name].grad.cpu()
            out[name] = ((param.grad.cpu() - ref).abs().max()
                         / ref.abs().max()).item()
    return out


def summary(errs: dict) -> str:
    grads = {k: v for k, v in errs.items() if k != "loss"}
    early = {k: v for k, v in grads.items() if k.startswith(
        ("merger", "subject", "encoders.meg.sequence.0."))}
    worst, worst_early = max(grads.values()), max(early.values())
    return (f"loss {errs['loss']:.1e}, gradients: worst {worst:.1e}, the "
            f"head and layer 0's worst {worst_early:.1e}")


def main() -> None:
    device = torch.device("cuda", 0)
    print(cs.card())
    _build.build()
    _build.library()
    norm_arrays, _ = cs.seeded_arrays()
    batch = cs.make_request(np.random.RandomState(3), cs.HELD_B,
                            norm_arrays["rec_positions"])
    rows = np.random.RandomState(4).randn(
        N_NEGATIVES - cs.HELD_B, cs.F, cs.T - 18).astype(np.float32)
    weight = np.ones(len(rows), np.float32)
    rows[-4:], weight[-4:] = 0., 0.
    for name, (simpleconv, optim) in VARIANTS.items():
        t0 = time.perf_counter()
        torch.set_num_threads(8)
        cpu = held("cpu", simpleconv, optim, batch, (rows, weight))
        card = held(device, simpleconv, optim, batch, (rows, weight))
        print(f"{name}: card against the CPU at 8 threads: "
              f"{summary(errors(card, cpu))}")
        if name in SPREAD:
            torch.set_num_threads(1)
            one = held("cpu", simpleconv, optim, batch, (rows, weight))
            print(f"{name}: the CPU at 1 thread against 8 threads: "
                  f"{summary(errors(one, cpu))}")
        print(f"  ({time.perf_counter() - t0:.1f} s)")
    torch.set_num_threads(8)
    simpleconv, optim = VARIANTS["all"]
    cpu = held("cpu", simpleconv, optim, batch, (rows, weight), True)
    card = held(device, simpleconv, optim, batch, (rows, weight), True)
    print(f"all in float64: card against the CPU: "
          f"{summary(errors(card, cpu))}")


if __name__ == "__main__":
    main()
