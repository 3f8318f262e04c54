"""Whether a B=256 train step of the paper model gives the same bits twice
on one card, and what holding cuDNN to deterministic algorithms costs.

For the clip_conv_tpu recipe and fp32 clip_conv (chip_smoke's
``build_trainer``, fused_conv_bn, one seeded batch), four variants:
cuDNN's own choice of algorithm ("free") or deterministic algorithms
only (``precision.deterministic_cudnn``, "held", what ``Solver``
runs), each with ``conv_stats``' dx as a forward conv of dY (what
``ops/conv_bn.py`` runs) or as cuDNN's backward-data
(``torch.nn.grad.conv1d_input``, the earlier design). Each prints how
many of the parameters' gradients differ between three
``loss_and_grad`` calls from the same seeds, the warm step's device
time (CUDA events, median of steps 2-6) and the three cuDNN kernels
with the most device time in one profiled step.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/torch_cudnn_determinism.py

It needs about a minute.
"""

import statistics
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from brainmagick_tpu_torch import dataset, solver  # noqa: E402
from brainmagick_tpu_torch.ops import _build, conv_bn  # noqa: E402
from brainmagick_tpu_torch.precision import exact_fp32  # noqa: E402

HELD = solver.Solver.loss_and_grad
FREE = exact_fp32()(HELD.__wrapped__.__wrapped__)
FORWARD_DX = conv_bn._ConvStats.backward


def backward_data_dx(ctx, dy, ds, dss):
    """``_ConvStats.backward`` with dx from cuDNN's backward-data."""
    x, w, y = ctx.saved_tensors
    d = ctx.dilation
    dY = torch.zeros(y.shape, dtype=torch.float32, device=y.device) \
        if dy is None else dy.float()
    if ds is not None:
        dY = dY + ds[None, :, None]
    if dss is not None:
        dY = dY + 2.0 * y.float() * dss[None, :, None]
    dY = dY.to(x.dtype)
    pad = (w.shape[2] // 2) * d
    dx = torch.nn.grad.conv1d_input(x.shape, w, dY, padding=pad, dilation=d)
    dw = torch.nn.grad.conv1d_weight(x, w.shape, dY, padding=pad, dilation=d)
    return dx, dw, None


def run(device, batch, preset: str) -> str:
    grads = []
    for _ in range(3):
        trainer = cs.build_trainer(device, preset)
        arrays = dataset.to_device(batch, device,
                                   trainer.args.parallel.transfer_dtype)
        trainer.solver.loss_and_grad(
            arrays, torch.ones(cs.TRAIN_B, device=device), train=True)
        grads.append([p.grad.cpu() for p in trainer.model.parameters()
                      if p.grad is not None])
    differ = sum(not all(torch.equal(g, other[i]) for other in grads[1:])
                 for i, g in enumerate(grads[0]))
    ms = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step(batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step(batch)
        torch.cuda.synchronize()
    cudnn = sorted((e for e in prof.key_averages() if "cudnn" in e.key
                    or "xmma" in e.key or "grad" in e.key),
                   key=lambda e: -e.device_time_total)[:3]
    top = "; ".join(f"{e.key[:60]} x{e.count} {e.device_time_total / 1e3:.2f}"
                    f" ms" for e in cudnn)
    return (f"{differ} of {len(grads[0])} gradients differ; warm step "
            f"{statistics.median(ms[1:]):.2f} ms; {top}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_cudnn_determinism.py needs a CUDA device")
    device = torch.device("cuda", 0)
    print(cs.card(), torch.__version__, torch.version.cuda)
    _build.build()
    _build.library()
    norm_arrays, _ = cs.seeded_arrays()
    batch = cs.make_request(np.random.RandomState(cs.SEED), cs.TRAIN_B,
                            norm_arrays["rec_positions"])
    for preset in (cs.RECIPE, "clip_conv"):
        for cudnn_name, loss_and_grad in (("free", FREE), ("held", HELD)):
            for dx_name, backward in (("forward conv", FORWARD_DX),
                                      ("backward-data", backward_data_dx)):
                solver.Solver.loss_and_grad = loss_and_grad
                conv_bn._ConvStats.backward = staticmethod(backward)
                print(f"{preset}, cuDNN {cudnn_name}, dx by {dx_name}: "
                      f"{run(device, batch, preset)}", flush=True)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
