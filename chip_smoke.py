"""Drive the PyTorch port's serving path once on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines; any failed check raises, so the script
exits non-zero and prints no result:

1. card and environment: the card's name and power limit (nvidia-smi),
   torch/CUDA/triton versions; TF32 is turned off so fp32 means fp32;
2. build: the CUDA kernels from brainmagick_tpu_torch/csrc (nvcc) and the
   Triton kernel, timed as set-up;
3. each kernel against its plain PyTorch version on the card, at a few
   ragged shapes and at the serving path's shapes, with the median time
   of both at the latter;
4. the serving slice at the clip_conv preset's full width (273 sensors,
   361 samples, 1024 features, random seeded weights): four requests
   through Server.forward_batch and Server.probabilities against a bank of
   2048 candidates, with each kernel's launch count over those requests,
   and the smallest request held against the same server on the CPU.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it raises at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
import types

import numpy as np
import torch

SEED = 0
#: clip_conv at full width: sensors, samples (3 s at 120 Hz), features
C, T, F = 273, 361, 1024
N_RECORDINGS = N_SUBJECTS = 4
#: the recording whose sensors past this index have no position
MASKED_RECORDING, VALID_SENSORS = 3, 208
REQUESTS = (256, 256, 64, 1)
N_CANDIDATES = 2048
LIMIT = 20.0                     # norm.max_scale
SCORE_K = F * (T - 18)           # F x T' after the 150 ms offset: 351,232
#: nt_matmul: max |kernel - plain| / (|a_m| |b_n|), both fp32-accumulated
MATMUL_TOL = 1e-6
#: the card's estimates against the CPU's (fp32, TF32 off; cuDNN and the
#: CPU sum in other orders): allclose rtol = atol
REFERENCE_TOL = 1e-4
PROBS_TOL = 1e-5
STEADY_RUNS = 5
#: shapes beyond the serving path's that each kernel is also checked at
RAGGED_NORM = ((1, 1, 1), (2, 3, 5), (3, 200, 61))
RAGGED_MATMUL = ((1, 1, 1), (3, 5, 7), (65, 130, 33), (100, 70, 1000))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median device time of `fn` over `runs` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_normalize(device: torch.device) -> dict:
    """normalize_clamp_peak at [256, 273, 361] fp32, limit 20: out and
    peak must equal the plain version exactly (IEEE division in both)."""
    from brainmagick_tpu_torch.ops import norm

    gen = torch.Generator(device=device).manual_seed(SEED)
    B = REQUESTS[0]
    meg = torch.randn((B, C, T), generator=gen, device=device) * 30
    center = torch.randn((B, C), generator=gen, device=device)
    scale = 0.5 + torch.rand((B, C), generator=gen, device=device)
    # ragged shapes (B=1, rows shorter and longer than one block) first
    for shape in RAGGED_NORM:
        for clip in (True, False):
            x = meg[:shape[0], :shape[1], :shape[2]].contiguous()
            c, s = (t[:shape[0], :shape[1]].contiguous()
                    for t in (center, scale))
            got = norm.normalize_clamp_peak(x, c, s, LIMIT, clip=clip)
            want = norm._reference_impl(x, c, s, LIMIT, clip)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"normalize_clamp_peak {shape} "
                                     f"clip={clip} differs from plain")
    out, peak = norm.normalize_clamp_peak(meg, center, scale, LIMIT)
    out_ref, peak_ref = norm._reference_impl(meg, center, scale, LIMIT, True)
    torch.cuda.synchronize()
    err = max((out - out_ref).abs().max().item(),
              (peak - peak_ref).abs().max().item())
    if err != 0 or not (peak > LIMIT).any():
        raise AssertionError(f"normalize_clamp_peak differs from the plain "
                             f"version by {err} (exact match required)")
    ms = median_ms(lambda: norm.normalize_clamp_peak(meg, center, scale,
                                                     LIMIT))
    plain_ms = median_ms(lambda: norm._reference_impl(meg, center, scale,
                                                      LIMIT, True))
    gbytes = 2 * meg.numel() * 4 / 1e9
    print(f"normalize_clamp_peak [{B}, {C}, {T}] fp32: max|diff| {err} "
          f"(exact); kernel {ms:.4f} ms ({gbytes / ms * 1e3:.1f} GB/s), "
          f"plain {plain_ms:.4f} ms ({gbytes / plain_ms * 1e3:.1f} GB/s)")
    return dict(name="normalize_clamp_peak", route="triton",
                source="brainmagick_tpu_torch/ops/norm.py",
                replaces="brainmagick_tpu/ops/pallas_norm.py:51",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_nt_matmul(device: torch.device) -> dict:
    """nt_matmul at M in {1, 256}, N 2048, K 351,232 on fp32 and bf16
    operands against the plain version (fp32 accumulation, TF32 off)."""
    from brainmagick_tpu_torch.ops import matmul

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    # ragged shapes: partial tiles in M, N and K, and K shorter than a step
    for rows, cols, depth in RAGGED_MATMUL:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((rows, depth), generator=gen, device=device)
            b = torch.randn((cols, depth), generator=gen, device=device)
            a, b = a.to(dtype), b.to(dtype)
            diff = (matmul.nt_matmul(a, b) - matmul._reference_impl(a, b))
            scale = (a.float().norm(dim=1)[:, None]
                     * b.float().norm(dim=1)[None, :])
            if not (diff.abs() / scale).max().item() <= MATMUL_TOL:
                raise AssertionError(f"nt_matmul {(rows, cols, depth)} "
                                     f"{dtype} differs from plain")
    m, n = REQUESTS[0], N_CANDIDATES
    a32 = torch.randn((m, SCORE_K), generator=gen, device=device)
    b32 = torch.randn((n, SCORE_K), generator=gen, device=device)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        a_all, b = a32.to(dtype), b32.to(dtype)
        for rows in (1, m):
            a = a_all[:rows]
            got = matmul.nt_matmul(a, b)
            want = matmul._reference_impl(a, b)
            torch.cuda.synchronize()
            scale = (a.float().norm(dim=1)[:, None]
                     * b.float().norm(dim=1)[None, :])
            abs_err = (got - want).abs().max().item()
            rel_err = ((got - want).abs() / scale).max().item()
            if not rel_err <= MATMUL_TOL:
                raise AssertionError(
                    f"nt_matmul {dtype} M={rows}: max|diff|/(|a||b|) "
                    f"{rel_err} > {MATMUL_TOL}")
            ms = median_ms(lambda: matmul.nt_matmul(a, b))
            plain_ms = median_ms(lambda: matmul._reference_impl(a, b))
            tflops = 2 * rows * n * SCORE_K / 1e9
            print(f"nt_matmul [{rows}, {SCORE_K}] x [{n}, {SCORE_K}]^T "
                  f"{str(dtype).split('.')[-1]}: max|diff| {abs_err:.3e}, "
                  f"max|diff|/(|a||b|) {rel_err:.3e}; kernel {ms:.3f} ms "
                  f"({tflops / ms:.2f} TFLOP/s), plain {plain_ms:.3f} ms "
                  f"({tflops / plain_ms:.2f} TFLOP/s)")
            if dtype == torch.float32 and rows == m:
                summary = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
        del a_all, b
    return dict(name="nt_matmul", route="cuda",
                source="brainmagick_tpu_torch/csrc/nt_matmul.cu",
                replaces="brainmagick_tpu/ops/pallas_matmul.py:53",
                **summary)


def build_server(device):
    """The clip_conv preset at full width on `device`, from seeds only:
    port-initialized weights, BatchNorm running stats drawn from numpy
    (mean ~ N(0, 0.1), var ~ U(0.5, 1.5)) and seeded normalization
    arrays. Two calls give the same server on any device."""
    from brainmagick_tpu_torch.config import MainConfig, apply_preset
    from brainmagick_tpu_torch.models.common import INVALID_POSITION
    from brainmagick_tpu_torch.serve import Server

    rng = np.random.RandomState(SEED)
    rec_positions = rng.rand(N_RECORDINGS, C, 2).astype(np.float32)
    rec_positions[MASKED_RECORDING, VALID_SENSORS:] = INVALID_POSITION
    norm_arrays = dict(
        meg_center=(rng.randn(N_RECORDINGS, C) * 0.1).astype(np.float32),
        meg_scale=rng.uniform(0.5, 2.0, (N_RECORDINGS, C)).astype(np.float32),
        feat_center=rng.randn(F).astype(np.float32),
        feat_scale=rng.uniform(0.5, 2.0, F).astype(np.float32),
        rec_positions=rec_positions,
        rec_subjects=np.arange(N_RECORDINGS, dtype=np.int32))
    args = apply_preset(MainConfig(), "clip_conv")
    server = Server(args, C, F, N_SUBJECTS, None, None, norm_arrays, device,
                    generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for module in server.model.modules():
            if isinstance(module, torch.nn.BatchNorm1d):
                shape = module.running_mean.shape
                module.running_mean.copy_(torch.from_numpy(
                    (rng.randn(*shape) * 0.1).astype(np.float32)))
                module.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, shape).astype(np.float32)))
    return server, rec_positions


def make_request(rng: np.random.RandomState, batch: int,
                 rec_positions: np.ndarray) -> types.SimpleNamespace:
    rec = np.arange(batch) % N_RECORDINGS
    return types.SimpleNamespace(
        meg=(rng.randn(batch, C, T) * 5).astype(np.float32),
        features=rng.randn(batch, F, T).astype(np.float32),
        features_mask=np.ones((batch, 1, T), dtype=bool),
        subject_index=rec.astype(np.int32),     # a recording binds its subject
        recording_index=rec.astype(np.int32),
        positions=rec_positions[rec])


def run_slice(device: torch.device, card_name: str) -> dict:
    from brainmagick_tpu_torch import ops

    server, rec_positions = build_server(device)
    rng = np.random.RandomState(SEED + 2)
    requests = [make_request(rng, b, rec_positions) for b in REQUESTS]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    t_out = T - server.solver._offsets()[0]
    bank = torch.randn((N_CANDIDATES, F, t_out), generator=gen,
                       device=device)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    results = []
    for batch in requests:
        b = len(batch.meg)
        t0 = time.perf_counter()
        estimate, output, mask, keep = server.forward_batch(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probs = server.probabilities(estimate, bank)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if estimate.shape != (b, F, t_out) or output.shape != (b, F, t_out):
            raise AssertionError(f"estimate {tuple(estimate.shape)}, output "
                                 f"{tuple(output.shape)}; want "
                                 f"{(b, F, t_out)}")
        if probs.shape != (b, N_CANDIDATES):
            raise AssertionError(f"probabilities {tuple(probs.shape)}")
        for name, t in (("estimate", estimate), ("output", output),
                        ("probabilities", probs)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"non-finite {name} at B={b}")
        row_err = (probs.sum(dim=1) - 1).abs().max().item()
        if row_err > PROBS_TOL or not keep.all() or mask.shape != (
                b, 1, t_out):
            raise AssertionError(f"B={b}: probability rows off 1 by "
                                 f"{row_err}, keep {keep.tolist()[:8]}")
        print(f"request B={b}: forward {(t1 - t0) * 1e3:.2f} ms, scoring "
              f"against {N_CANDIDATES} candidates {(t2 - t1) * 1e3:.2f} ms "
              f"(host clock, synchronized; {card_name})")
        results.append((batch, estimate, probs))
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    print(f"kernel launches over the {len(REQUESTS)} requests: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the serving path never launched {name}")

    # the smallest request, held against the same server on the CPU
    batch, estimate, _ = results[-1]
    reference, _ = build_server("cpu")
    est_ref, _, _, _ = reference.forward_batch(batch)
    est_err = (estimate.cpu() - est_ref).abs().max().item()
    if not torch.allclose(estimate.cpu(), est_ref, rtol=REFERENCE_TOL,
                          atol=REFERENCE_TOL):
        raise AssertionError(f"card vs CPU estimate: max|diff| {est_err}")
    cands = bank[:64]
    probs = server.probabilities(estimate, cands).cpu()
    probs_ref = reference.probabilities(est_ref, cands.cpu())
    probs_err = (probs - probs_ref).abs().max().item()
    if probs_err > PROBS_TOL:
        raise AssertionError(f"card vs CPU probabilities: max|diff| "
                             f"{probs_err}")
    print(f"B=1 against the CPU: estimate max|diff| {est_err:.3e} "
          f"(rtol=atol={REFERENCE_TOL}), probabilities over 64 candidates "
          f"max|diff| {probs_err:.3e} (atol {PROBS_TOL})")

    # each request above was its batch size's first call (cuDNN picks its
    # algorithms then); the steady state of the largest one, warm
    batch = requests[0]
    forward_ms, scoring_ms = [], []
    for _ in range(STEADY_RUNS):
        t0 = time.perf_counter()
        estimate, _, _, _ = server.forward_batch(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        server.probabilities(estimate, bank)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        forward_ms.append((t1 - t0) * 1e3)
        scoring_ms.append((t2 - t1) * 1e3)
    print(f"warm B={len(batch.meg)} over {STEADY_RUNS} runs: forward median "
          f"{statistics.median(forward_ms):.2f} ms, scoring median "
          f"{statistics.median(scoring_ms):.2f} ms ({card_name})")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    from brainmagick_tpu_torch.ops import _build, normalize_clamp_peak

    device = torch.device("cuda", 0)
    card_name = card()
    print(card_name)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "missing"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
          f"{triton_version}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"built {path.relative_to(_build.PACKAGE_DIR.parent)} from "
          f"{[s.name for s in _build._sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")
    t0 = time.perf_counter()
    row = torch.ones((1, 1), device=device)
    normalize_clamp_peak(row[:, :, None].contiguous(), row, row, LIMIT)
    torch.cuda.synchronize()
    print(f"compiled the Triton kernel of brainmagick_tpu_torch/ops/norm.py "
          f"in {time.perf_counter() - t0:.1f} s")

    kernels = [check_normalize(device), check_nt_matmul(device)]
    launches = run_slice(device, card_name)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(card_name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
