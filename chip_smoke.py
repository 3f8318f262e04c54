"""Drive the PyTorch port's serving and training paths on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines; any failed check raises, so the script
exits non-zero and prints no result:

1. card and environment: the card's name and power limit (nvidia-smi),
   torch/CUDA/triton versions; TF32 is turned off so fp32 means fp32;
2. build: the CUDA kernels from brainmagick_tpu_torch/csrc (nvcc) and the
   Triton kernel, timed as set-up;
3. each kernel against its plain PyTorch version on the card, at a few
   ragged shapes and at the shapes its path gives it, with the median time
   of both at the latter (conv_stats forward and backward, TF32 off);
4. the serving slice at the clip_conv preset's full width (273 sensors,
   361 samples, 1024 features, random seeded weights): four requests
   through Server.forward_batch and Server.probabilities against a bank of
   2048 candidates, with each kernel's launch count over those requests,
   and the smallest request held against the same server on the CPU;
5. the training slice at the same width with simpleconv.fused_conv_bn:
   five Adam steps of Trainer.step at B=256 on one seeded batch (finite
   losses that fall, conv_stats launched once per encoder layer per step,
   normalize once per step), the warm step's time and peak memory, and a
   B=8 step held against the same trainer on the CPU.

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
#: conv_stats: each error over its Cauchy-Schwarz bound. y: |dy| / (|w_o|
#: |x window|); s, ss: over the sums of that bound and of its square; dx,
#: dw: over |w[:, c]| |dY_b| and |x_c| |dY_o|. fp32: both sides accumulate
#: in fp32 in other orders (cuDNN against the kernel, torch.sum against
#: the kernel's fixed-order partial sums).
CONV_TOL = 1e-5
#: bf16: y may land one bf16 rounding apart (2^-8 of |y| on top of
#: CONV_TOL), and the kernel's backward rounds dY to bf16 where the plain
#: version's fp32 autograd does not (2^-7 of the bound)
CONV_GRAD_TOL_BF16 = 2 ** -7
#: (B, C, O, T, dilation) checked in fp32 and bf16: partial tiles in every
#: dimension, and the widest halo at a short T
RAGGED_CONV = ((1, 1, 1, 1, 1), (2, 3, 5, 7, 2), (2, 17, 33, 130, 4),
               (3, 270, 320, 37, 16))
#: the encoder's layers at the paper shape: C=320 at each dilation, and the
#: first layer's C=270
PAPER_CONV = tuple((REQUESTS[0], 320, 320, T - 18, d)
                   for d in (1, 2, 4, 8, 16)) + ((REQUESTS[0], 270, 320,
                                                  T - 18, 1),)
TRAIN_B, TRAIN_STEPS, HELD_B = 256, 5, 8
#: the B=8 step on the card against the CPU (fp32, TF32 off; cuDNN and the
#: CPU sum in other orders): loss relative, each gradient's max error over
#: its max magnitude, running statistics allclose rtol = atol
STEP_TOL = 1e-4
#: the kernels each path must launch
SERVE_KERNELS = ("normalize_clamp_peak", "nt_matmul")
HELD_LEAVES = ("merger.heads", "subject_layers.weights",
               "encoders.meg.sequence.0.0.weight",
               "encoders.meg.sequence.9.1.weight",
               "encoders.meg.glus.9.0.weight", "final.2.weight")
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


def _conv_case(shape, dtype, device, gen):
    """Seeded conv_stats operands and backward cotangents at (B, C, O, T,
    d): x [B, C, T], w [O, C, 3] (LeCun scale), G for y, a and b for s
    and ss."""
    B, Cin, O, Tc, _ = shape
    x = torch.randn((B, Cin, Tc), generator=gen, device=device).to(dtype)
    w = (torch.randn((O, Cin, 3), generator=gen, device=device)
         / (3 * Cin) ** 0.5).to(dtype)
    cot = (torch.randn((B, O, Tc), generator=gen, device=device).to(dtype),
           torch.randn(O, generator=gen, device=device),
           torch.randn(O, generator=gen, device=device) * 0.1)
    return x, w, cot


def _conv_grads(fn, x, w, d, cot):
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    return torch.autograd.grad(fn(xr, wr, d), (xr, wr), cot)


def _conv_errors(x, w, d, cot, got, want, got_grads, want_grads):
    """Each conv_stats error over its Cauchy-Schwarz bound (CONV_TOL)."""
    import torch.nn.functional as fn

    x32, w32 = x.float(), w.float()
    k = w.shape[2]
    window = fn.conv1d(x32 * x32, torch.ones((1, x.shape[1], k),
                                             device=x.device),
                       padding=(k // 2) * d, dilation=d).sqrt()
    bound = w32.flatten(1).norm(dim=1)[None, :, None] * window  # [B, O, T]
    y_ref = want[0].float()
    rounding = 2 ** -8 * y_ref.abs() if x.dtype == torch.bfloat16 else 0.
    dY = (cot[0].float() + cot[1][None, :, None]
          + 2 * y_ref * cot[2][None, :, None])
    dx_bound = (w32.norm(dim=(0, 2))[None, :, None]
                * dY.flatten(1).norm(dim=1)[:, None, None])
    dw_bound = (dY.norm(dim=(0, 2))[:, None, None]
                * x32.norm(dim=(0, 2))[None, :, None])
    return dict(
        y=((got[0].float() - y_ref).abs() / (bound + rounding)).max().item(),
        s=((got[1] - want[1]).abs() / bound.sum((0, 2))).max().item(),
        ss=((got[2] - want[2]).abs() / (bound ** 2).sum((0, 2))).max().item(),
        dx=((got_grads[0].float() - want_grads[0].float()).abs()
            / dx_bound).max().item(),
        dw=((got_grads[1].float() - want_grads[1].float()).abs()
            / dw_bound).max().item(),
        abs_y=(got[0].float() - y_ref).abs().max().item())


def check_conv_stats(device: torch.device) -> dict:
    """conv_stats forward (y, s, ss) and backward (dx, dw through autograd)
    against its plain version's autograd: ragged shapes in fp32 and bf16,
    the encoder's paper shapes in fp32; then the median times of both,
    forward and forward + backward, at [256, 320, 343]."""
    from brainmagick_tpu_torch.ops import conv_bn

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    cases = [(shape, dtype) for shape in RAGGED_CONV
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(shape, torch.float32) for shape in PAPER_CONV]
    summary = {}
    for shape, dtype in cases:
        d = shape[-1]
        x, w, cot = _conv_case(shape, dtype, device, gen)
        got = conv_bn.conv_stats(x, w, d)
        want = conv_bn._reference_impl(x, w, d)
        got_grads = _conv_grads(conv_bn.conv_stats, x, w, d, cot)
        want_grads = _conv_grads(conv_bn._reference_impl, x, w, d, cot)
        torch.cuda.synchronize()
        errors = _conv_errors(x, w, d, cot, got, want, got_grads, want_grads)
        bf16 = dtype == torch.bfloat16
        limits = dict(y=CONV_TOL, s=CONV_TOL, ss=CONV_TOL,
                      dx=CONV_GRAD_TOL_BF16 if bf16 else CONV_TOL,
                      dw=CONV_GRAD_TOL_BF16 if bf16 else CONV_TOL)
        name = str(dtype).split(".")[-1]
        print(f"conv_stats {shape} {name}: " + ", ".join(
            f"{key} {value:.2e}" for key, value in errors.items())
            + " (over their bounds; abs_y is max|dy|)")
        for key, limit in limits.items():
            if not errors[key] <= limit:
                raise AssertionError(f"conv_stats {shape} {name}: {key} "
                                     f"error {errors[key]} > {limit}")
        if shape == PAPER_CONV[0]:
            summary["max_abs_err"] = errors["abs_y"]
        del x, w, cot, got, want, got_grads, want_grads

    B, Cin, O, Tc, d = PAPER_CONV[0]
    x, w, cot = _conv_case(PAPER_CONV[0], torch.float32, device, gen)
    gflop = 2 * B * Cin * O * Tc * 3 / 1e9
    times = {}
    for label, fn in (("kernel", conv_bn.conv_stats),
                      ("plain", conv_bn._reference_impl)):
        times[label] = (median_ms(lambda: fn(x, w, d)),
                        median_ms(lambda: _conv_grads(fn, x, w, d, cot)))
    (ms, ms_bwd), (plain_ms, plain_bwd) = times["kernel"], times["plain"]
    print(f"conv_stats [{B}, {Cin}, {Tc}] x [{O}, {Cin}, 3] d={d} fp32 "
          f"forward: kernel {ms:.3f} ms ({gflop / ms:.1f} TFLOP/s), plain "
          f"{plain_ms:.3f} ms ({gflop / plain_ms:.1f} TFLOP/s); forward + "
          f"backward: kernel {ms_bwd:.3f} ms, plain {plain_bwd:.3f} ms")
    return dict(name="conv_stats", route="cuda",
                source="brainmagick_tpu_torch/csrc/conv_stats.cu",
                replaces="brainmagick_tpu/ops/pallas_conv_bn.py:89",
                ms=ms, plain_ms=plain_ms, fwd_bwd_ms=ms_bwd,
                plain_fwd_bwd_ms=plain_bwd, **summary)


def seeded_arrays():
    """Seeded normalization arrays and per-recording sensor positions
    (the last recording's sensors past VALID_SENSORS have none)."""
    from brainmagick_tpu_torch.models.common import INVALID_POSITION

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
    return norm_arrays, rng


def build_server(device):
    """The clip_conv preset at full width on `device`, from seeds only:
    port-initialized weights, BatchNorm running stats drawn from numpy
    (mean ~ N(0, 0.1), var ~ U(0.5, 1.5)) and seeded normalization
    arrays. Two calls give the same server on any device."""
    from brainmagick_tpu_torch.config import MainConfig, apply_preset
    from brainmagick_tpu_torch.serve import Server

    norm_arrays, rng = seeded_arrays()
    rec_positions = norm_arrays["rec_positions"]
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


def run_slice(device: torch.device, card_name: str):
    """The serving slice; returns its kernel launch counts and its first
    B=256 request (the train slice's batch)."""
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
    for name in SERVE_KERNELS:
        if launches[name] == 0:
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
    return launches, requests[0]


def build_trainer(device):
    """The clip_conv preset with simpleconv.fused_conv_bn at full width on
    `device`, from seeds only (port-initialized weights, seeded
    normalization arrays, the dropout generator seeded SEED). Two calls
    give the same trainer on any device, drawing the same dropout disks."""
    from brainmagick_tpu_torch.config import MainConfig, apply_preset
    from brainmagick_tpu_torch.train import Trainer

    norm_arrays, _ = seeded_arrays()
    args = apply_preset(MainConfig(), "clip_conv")
    args.simpleconv["fused_conv_bn"] = True
    return Trainer(args, C, F, N_SUBJECTS, None, None, norm_arrays, device,
                   generator=torch.Generator().manual_seed(SEED))


def run_train(device: torch.device, card_name: str, batch) -> dict:
    """TRAIN_STEPS Adam steps of Trainer.step on one B=256 batch, then a
    B=8 step held against the same trainer on the CPU. Returns the kernel
    launch counts over the TRAIN_STEPS steps."""
    from brainmagick_tpu_torch import dataset, ops

    trainer = build_trainer(device)
    n_fused = sum(trainer.model.encoders["meg"].fused)
    if n_fused != 10:
        raise AssertionError(f"{n_fused} fused encoder layers, want 10")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        loss = metrics["loss"].item()                   # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if {metrics["keep"].item(), metrics["count"].item()} != {TRAIN_B}:
            raise AssertionError(f"keep/count {metrics}")
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train B={TRAIN_B}: losses {losses}; step times "
          f"{[round(t, 2) for t in step_ms]} ms (host clock, synchronized, "
          f"host-to-device copy included; {card_name})")
    print(f"train warm step median over steps 2-{TRAIN_STEPS}: "
          f"{statistics.median(step_ms[1:]):.2f} ms; peak device memory "
          f"{peak_gb:.2f} GB; kernel launches over the {TRAIN_STEPS} steps: "
          f"{launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: want finite, and the "
                             f"last below the first")
    want = dict(conv_stats=n_fused * TRAIN_STEPS,
                normalize_clamp_peak=TRAIN_STEPS)
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"train path launched {name} "
                                 f"{launches[name]} times, want {count}")
    del trainer, metrics
    torch.cuda.empty_cache()

    # a B=8 step on the card against the same trainer on the CPU
    small = types.SimpleNamespace(**{
        name: getattr(batch, name)[:HELD_B] for name in dataset.ARRAY_FIELDS})
    held = {}
    for where in (device, "cpu"):
        trainer = build_trainer(where)
        loss = trainer.step(small)["loss"].item()
        held[str(where)] = (loss, trainer.model)
    (loss, model), (loss_ref, model_ref) = held[str(device)], held["cpu"]
    errors = {"loss": abs(loss - loss_ref) / abs(loss_ref)}
    for name in HELD_LEAVES:
        grad = model.get_parameter(name).grad.cpu()
        ref = model_ref.get_parameter(name).grad
        errors[f"grad {name}"] = ((grad - ref).abs().max()
                                  / ref.abs().max()).item()
    stats = dict(model_ref.named_buffers())
    for name, buf in model.named_buffers():
        if "running" in name and not torch.allclose(
                buf.cpu(), stats[name], rtol=STEP_TOL, atol=STEP_TOL):
            raise AssertionError(f"card vs CPU {name}: max|diff| "
                                 f"{(buf.cpu() - stats[name]).abs().max()}")
    stat_err = max((buf.cpu() - stats[name]).abs().max().item()
                   for name, buf in model.named_buffers() if "running" in name)
    print(f"train B={HELD_B} against the CPU: " + ", ".join(
        f"{key} {value:.2e}" for key, value in errors.items())
        + f" (relative; tol {STEP_TOL}); running statistics max|diff| "
        f"{stat_err:.2e} (rtol=atol={STEP_TOL})")
    for key, value in errors.items():
        if not value <= STEP_TOL:
            raise AssertionError(f"card vs CPU train step: {key} {value}")
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

    kernels = [check_normalize(device), check_nt_matmul(device),
               check_conv_stats(device)]
    serve_launches, batch = run_slice(device, card_name)
    train_launches = run_train(device, card_name, batch)
    for entry in kernels:
        by_path = dict(serve=serve_launches[entry["name"]],
                       train=train_launches[entry["name"]])
        entry["launches"] = by_path["serve"] + by_path["train"]
        entry["launches_by_path"] = by_path
    print(card_name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
