"""Profile the PyTorch port's train step and serving request on one CUDA
card.

Run from the repository root:

    python3 scripts/torch_profile_train.py [--preset clip_conv_tpu]
    python3 scripts/torch_profile_train.py --preset deep_mel

Builds chip_smoke.py's trainer (the preset, clip_conv by default or the
bf16 clip_conv_tpu, at full width with simpleconv.fused_conv_bn, seeded
weights; deep_mel is clip_conv with Table 2's DeepMel feature model at
its published 320 x 10 -> 768 over MELS mel features, the batch's first
MELS feature channels) and one seeded batch of chip_smoke.TRAIN_B = 256,
moves the
batch to the card once (in the preset's parallel.transfer_dtype), times
WARM Solver.step calls on those resident arrays (host clock,
synchronized), then profiles STEPS more with torch.profiler and prints
the device time per step of the ROWS largest kernels, with the device's
busy share of the host time. Then the same for a serving request of the
preset (chip_smoke.py's server): Server.forward_batch of the B=256 batch
and Server.probabilities against a bank of 2048 candidates stored in the
scores' compute dtype, WARM requests timed, STEPS profiled. The entry
points turn TF32 off themselves (precision.exact_fp32), so the script
leaves torch's flags as they are. deep_mel profiles the train step
only (``serve.Server`` takes no feature model). Without a CUDA device it
exits 1.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: warm steps timed on the host clock, profiled steps, kernels printed
WARM, STEPS, ROWS = 5, 3, 25
#: deep_mel's mel features (the default MelSpectrum's n_mels)
MELS = 120


def profiled(fn, label: str, unit: str) -> None:
    """Time WARM calls of `fn` (each ends in a synchronize) by the host
    clock, profile STEPS more, and print the device time per call of the
    ROWS largest kernels and the device's busy share."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    host_ms = []
    for _ in range(WARM):
        t0 = time.perf_counter()
        fn()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            fn()
    profiled_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    device_us = chip_smoke.device_us
    kernels = [(e.key, device_us(e) / 1e3 / STEPS, e.count)
               for e in prof.key_averages() if device_us(e) > 0
               and e.device_type != torch.autograd.DeviceType.CPU]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    print(f"profiled {len(kernels)} kernels over {STEPS} {unit}s")
    print(f"{label}: host clock {[round(t, 3) for t in host_ms]} ms (median "
          f"of {unit}s 2-{WARM}: {statistics.median(host_ms[1:]):.3f} ms); "
          f"profiled {unit}s {profiled_ms:.3f} ms each, device "
          f"{device_ms:.3f} ms each ({100 * device_ms / profiled_ms:.1f}% "
          f"busy)")
    for name, ms, count in kernels[:ROWS]:
        print(f"  {ms:9.3f} ms  {count // STEPS:4d}x  {name[:110]}")


def deep_mel_trainer(device: torch.device, norm_arrays: dict):
    """clip_conv + deep_mel with fused_conv_bn over MELS features, as
    chip_smoke.build_trainer builds its presets."""
    import chip_smoke
    from brainmagick_tpu_torch.config import MainConfig, apply_preset
    from brainmagick_tpu_torch.train import Trainer

    args = apply_preset(apply_preset(MainConfig(), "clip_conv"), "deep_mel")
    args.simpleconv["fused_conv_bn"] = True
    arrays = dict(norm_arrays, feat_center=norm_arrays["feat_center"][:MELS],
                  feat_scale=norm_arrays["feat_scale"][:MELS])
    return Trainer(args, chip_smoke.C, MELS, chip_smoke.N_SUBJECTS, None,
                   None, arrays, device,
                   generator=torch.Generator().manual_seed(chip_smoke.SEED))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="clip_conv",
                        choices=("clip_conv", "clip_conv_tpu", "deep_mel"))
    preset = parser.parse_args().preset
    if not torch.cuda.is_available():
        raise SystemExit("the profile needs a CUDA device; none is visible")
    import chip_smoke
    from brainmagick_tpu_torch import dataset, ops

    device = torch.device("cuda", 0)
    print(chip_smoke.card())
    norm_arrays, _ = chip_smoke.seeded_arrays()
    batch = chip_smoke.make_request(np.random.RandomState(chip_smoke.SEED + 2),
                                    chip_smoke.TRAIN_B,
                                    norm_arrays["rec_positions"])
    if preset == "deep_mel":
        trainer = deep_mel_trainer(device, norm_arrays)
        batch.features = np.ascontiguousarray(batch.features[:, :MELS])
    else:
        trainer = chip_smoke.build_trainer(device, preset)
    arrays = dataset.to_device(batch, device,
                               trainer.args.parallel.transfer_dtype)
    weight = torch.ones(chip_smoke.TRAIN_B, device=device)

    def step():
        loss = trainer.solver.step(arrays, weight, True)["loss"]
        return loss.item()                                  # synchronizes

    ops.reset_launch_counts()
    profiled(step, f"{preset} train step B={chip_smoke.TRAIN_B} "
             f"fused_conv_bn on resident arrays", "step")
    calls = WARM + STEPS
    print(f"conv_stats launches per step {ops.conv_stats.launches / calls:g},"
          f" by route {ops.conv_stats.launches_by_route}, by type "
          f"{ops.conv_stats.launches_by_dtype}")
    del trainer, arrays
    torch.cuda.empty_cache()
    if preset == "deep_mel":
        return

    server, _ = chip_smoke.build_server(device, preset)
    t_out = chip_smoke.T - server.solver._offsets()[0]
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 3)
    bank = torch.randn((chip_smoke.N_CANDIDATES, chip_smoke.F, t_out),
                       generator=gen, device=device)
    if server.clip.compute_dtype is not None:
        bank = bank.to(server.clip.compute_dtype)

    def request():
        estimate = server.forward_batch(batch)[0]
        server.probabilities(estimate, bank)
        torch.cuda.synchronize()

    profiled(request, f"{preset} request B={chip_smoke.TRAIN_B} (forward "
             f"with the batch's copy, scoring against "
             f"{chip_smoke.N_CANDIDATES} candidates)", "request")


if __name__ == "__main__":
    main()
