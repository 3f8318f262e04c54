"""Why a DeepMel's fp32 gradients in train mode part from float64, on the
card and on the CPU: the published DeepMel (120 mels -> 320 x 10 -> 768)
at [256, 120, 343], strided (stride 2, chip_smoke.py phase 18's) and not
(the DeepMel cell's). For each fp32 run (the card; the card without
cuDNN; the card with BatchNorm's batch variance in two passes,
mean((y - mean)^2), instead of flax's one, mean(y^2) - mean^2; the CPU)
and the card in float64, it prints how many ReLU inputs have another sign
than in the CPU's float64 run, a layer, and the output's, the input
gradient's and the first conv's weight gradient's max |diff| over max
|reference| against the CPU's float64 run: on the run's own ReLU masks,
and on the float64 run's (``chip_smoke.relu_masks``). A ReLU's gradient
steps at 0, so an input within rounding of 0 that flips moves the
gradients by a whole upstream gradient; on the same masks the runs differ
only by their arithmetic's rounding.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/torch_deepmel_relu_flips.py

It needs about two minutes (the CPU's float64 runs most of it).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from brainmagick_tpu_torch.models import common  # noqa: E402
from brainmagick_tpu_torch.models.features import DeepMel  # noqa: E402
from brainmagick_tpu_torch.precision import exact_fp32  # noqa: E402

X0 = np.random.RandomState(18).randn(256, 120, 343).astype(np.float32)


def run(where, dtype, stride: int, masks=None) -> tuple:
    """(output, input gradient, first conv's weight gradient) in float64
    on the CPU, and the ReLU masks the run took."""
    fm = DeepMel(n_in_channels=120, stride=stride)
    fm.reset_parameters(torch.Generator().manual_seed(0))
    fm = fm.to(where, dtype).train()
    x = torch.from_numpy(X0).to(where, dtype).requires_grad_()
    with cs.relu_masks(fm, masks) as seen:
        y = fm(x)
    cot = torch.from_numpy(np.random.RandomState(19).randn(
        *y.shape).astype(np.float32)).to(where, dtype)
    (y * cot).sum().backward()
    return tuple(t.detach().double().cpu() for t in (
        y, x.grad, fm.sequence[0][0].weight.grad)), [m.cpu() for m in seen]


def two_pass(self, x):
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if not self.training:
        return torch.nn.BatchNorm1d.forward(self, x32).to(x.dtype)
    mean = x32.mean(dim=(0, 2))
    var = ((x32 - mean[:, None]) ** 2).mean(dim=(0, 2))
    return self.normalize_train(x32, mean, var).to(x.dtype)


def variant(name: str, where, dtype, stride: int, masks=None) -> tuple:
    """`run` under the variant `name` (its cuDNN or BatchNorm setting)."""
    if name.endswith("without cuDNN"):
        with torch.backends.cudnn.flags(enabled=False):
            return run(where, dtype, stride, masks)
    if name.endswith("two-pass variance"):
        one_pass = common.BatchNorm.forward
        common.BatchNorm.forward = two_pass
        try:
            return run(where, dtype, stride, masks)
        finally:
            common.BatchNorm.forward = one_pass
    return run(where, dtype, stride, masks)


def main() -> None:
    device = torch.device("cuda", 0)
    print(cs.card(), torch.__version__, torch.version.cuda)
    runs = {"card fp32": (device, torch.float32),
            "card fp32 without cuDNN": (device, torch.float32),
            "card fp32, two-pass variance": (device, torch.float32),
            "card float64": (device, torch.float64),
            "CPU fp32": ("cpu", torch.float32)}
    with exact_fp32():
        for stride in (2, 1):
            ref, ref_masks = run("cpu", torch.float64, stride)
            for name, (where, dtype) in runs.items():
                got, masks = variant(name, where, dtype, stride)
                flips = [int((a != b).sum())
                         for a, b in zip(masks, ref_masks)]
                on_ref, _ = variant(name, where, dtype, stride, ref_masks)
                for label, out in (("own masks", got),
                                   ("float64's masks", on_ref)):
                    errs = [((g - r).abs().max() / r.abs().max()).item()
                            for g, r in zip(out, ref)]
                    print(f"DeepMel stride {stride}, {name} on its "
                          f"{label} against the CPU's float64: output "
                          f"{errs[0]:.2e}, input gradient {errs[1]:.2e}, "
                          f"first conv's weight gradient {errs[2]:.2e}")
                print(f"DeepMel stride {stride}, {name}: ReLU inputs of "
                      f"another sign than float64's, a layer: {flips}")


if __name__ == "__main__":
    main()
