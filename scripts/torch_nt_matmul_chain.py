"""bf16 nt_matmul's error against its number of K splits, on one CUDA card.

Run from the repository root:

    python3 scripts/torch_nt_matmul_chain.py

At 2048 x 2048 x 351,232 and 256 x 2048 x 351,232 (the evaluation's and
the serving batch's scoring shapes), for bf16 operands that are random, a
copy of the bank (a = b), the bank plus noise, and all positive, it forces
the K split to 1 … 86 and prints max|kernel - plain| / (|a_m| |b_n|) for
each (plain: the same bf16 values upcast, fp32 accumulation, TF32 off),
that of cuBLAS's torch.mm(out_dtype=float32), the planner's own choice,
and on random operands the kernel's median time at each split. Each split
is one accumulator chain of the tensor core, whose fp32 sum drifts with
the chain's length; ``ops.matmul.MAX_BF16_STEPS`` bounds it.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from brainmagick_tpu_torch.ops import _build, matmul  # noqa: E402
from brainmagick_tpu_torch.precision import exact_fp32  # noqa: E402

K, N = 351_232, 2048
SPLITS = (1, 4, 8, 16, 22, 33, 43, 64, 86)


def median_ms(fn, runs: int = 5) -> float:
    for _ in range(2):
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _build.build()
    _build.library()
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=device).manual_seed(0)
    bank = torch.randn((N, K), generator=gen, device=device)
    cases = {"random": torch.randn((N, K), generator=gen, device=device),
             "a=b": bank.clone(),
             "a=b+noise": bank + 0.5 * torch.randn((N, K), generator=gen,
                                                    device=device),
             "positive": bank.abs()}
    plan = matmul.plan_tiles
    steps = -(-K // (matmul.STEP_BYTES // 2))
    with exact_fp32():
        for rows in (2048, 256):
            width, _, own_splits, _ = plan(rows, N, K, 132, 2)
            print(f"M={rows}: the planner's bf16 split count {own_splits}")
            for name, a32 in cases.items():
                b = (bank.abs() if name == "positive" else bank).to(
                    torch.bfloat16)
                a = a32[:rows].to(torch.bfloat16)
                ref = a.float() @ b.float().T
                scale = (a.float().norm(dim=1)[:, None]
                         * b.float().norm(dim=1)[None, :])
                lib = torch.mm(a, b.T, out_dtype=torch.float32)
                line = [f"{name:10s} M={rows} torch.mm "
                        f"{((lib - ref).abs() / scale).max().item():.2e}"]
                for splits in SPLITS:
                    per = -(-steps // splits)
                    matmul.plan_tiles = (
                        lambda *_, per=per: (width, matmul.BANK_ROWS,
                                             -(-steps // per), per * 64))
                    try:
                        got = matmul.nt_matmul(a, b)
                        err = ((got - ref).abs() / scale).max().item()
                        ms = (median_ms(lambda: matmul.nt_matmul(a, b))
                              if name == "random" else None)
                    finally:
                        matmul.plan_tiles = plan
                    line.append(f"s{splits} {err:.2e}"
                                + (f" {ms:.3f} ms" if ms else ""))
                print(", ".join(line), flush=True)
                del ref, scale, lib, got


if __name__ == "__main__":
    main()
