"""Profile the PyTorch port's train step on one CUDA card.

Run from the repository root, with no arguments:

    python3 scripts/torch_profile_train.py

Builds chip_smoke.py's trainer (the clip_conv preset at full width with
simpleconv.fused_conv_bn, seeded weights) and one seeded batch of
chip_smoke.TRAIN_B = 256, moves the batch to the card once, times WARM
Solver.step calls on those resident arrays (host clock, synchronized),
then profiles STEPS more with torch.profiler and prints the device time
per step of the ROWS largest kernels, with the device's busy share of the
host time. Solver.step turns TF32 off itself (precision.exact_fp32), so
the script leaves torch's flags as they are. Without a CUDA device it
exits 1.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: warm steps timed on the host clock, profiled steps, kernels printed
WARM, STEPS, ROWS = 5, 3, 25


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the profile needs a CUDA device; none is visible")
    import chip_smoke
    from brainmagick_tpu_torch import dataset, ops
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda", 0)
    print(chip_smoke.card())
    trainer = chip_smoke.build_trainer(device)
    norm_arrays, _ = chip_smoke.seeded_arrays()
    batch = chip_smoke.make_request(np.random.RandomState(chip_smoke.SEED + 2),
                                    chip_smoke.TRAIN_B,
                                    norm_arrays["rec_positions"])
    arrays = dataset.to_device(batch, device)
    weight = torch.ones(chip_smoke.TRAIN_B, device=device)

    def step():
        loss = trainer.solver.step(arrays, weight, True)["loss"]
        return loss.item()                                  # synchronizes

    host_ms = []
    for _ in range(WARM):
        t0 = time.perf_counter()
        step()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            step()
    profiled_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    device_us = chip_smoke.device_us
    kernels = [(e.key, device_us(e) / 1e3 / STEPS, e.count)
               for e in prof.key_averages() if device_us(e) > 0
               and e.device_type != torch.autograd.DeviceType.CPU]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    print(f"profiled {len(kernels)} kernels over {STEPS} steps")
    print(f"train step B={chip_smoke.TRAIN_B} fused_conv_bn on resident "
          f"arrays: host clock {[round(t, 3) for t in host_ms]} ms (median "
          f"of steps 2-{WARM}: {statistics.median(host_ms[1:]):.3f} "
          f"ms); profiled steps {profiled_ms:.3f} ms each, device "
          f"{device_ms:.3f} ms each ({100 * device_ms / profiled_ms:.1f}% "
          f"busy); conv_stats launches per step "
          f"{ops.conv_stats.launches / STEPS:g}, by route "
          f"{ops.conv_stats.launches_by_route}")
    for name, ms, count in kernels[:ROWS]:
        print(f"  {ms:9.3f} ms  {count // STEPS:4d}x  {name[:110]}")


if __name__ == "__main__":
    main()
