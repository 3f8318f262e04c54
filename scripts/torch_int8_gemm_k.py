"""cuBLAS's int8 GEMM (``torch._int_mm``) at the evaluation's int8 score
chunk, against K: the chunk width of ``losses.INT8_K_CHUNK`` (133,144,
the largest whose int32 sum cannot overflow) as it is, padded to a
multiple of 16 and of 128, powers of two beside it, and the last chunk of
K = 351,232 (84,944); then the copy that pads one chunk of an operand,
and ``losses.int8_partial_sums`` over the whole K, from the tensors and
from the operands laid out once (``losses.int8_rows``).

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/torch_int8_gemm_k.py

It needs about twenty seconds.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from brainmagick_tpu_torch import losses  # noqa: E402

M = N = 2048
WIDTHS = (losses.INT8_K_CHUNK, 133152, 133248, 133376, 134144, 131072,
          84944, 84992)


def main() -> None:
    device = torch.device("cuda", 0)
    print(cs.card(), torch.__version__, torch.version.cuda)
    gen = torch.Generator(device=device).manual_seed(0)
    for k in WIDTHS:
        a = torch.randint(-127, 128, (M, k), generator=gen, device=device,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (N, k), generator=gen, device=device,
                          dtype=torch.int8)
        t = cs.median_ms(lambda: torch._int_mm(a, b.t()))
        print(f"{M} x {N} x K={k} (K % 16 = {k % 16}, % 128 = {k % 128}): "
              f"{t:.3f} ms, {2 * M * N * k / t / 1e9:.0f} TOP/s")
        del a, b
    kc, k = losses.INT8_K_CHUNK, cs.SCORE_K
    a = torch.randint(-127, 128, (M, k), generator=gen, device=device,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (N, k), generator=gen, device=device,
                      dtype=torch.int8)
    chunk = a[:, kc:2 * kc]
    t = cs.median_ms(lambda: F.pad(chunk, (0, 133248 - kc)))
    print(f"the zero-padding copy of one {M} x {kc} chunk: {t:.3f} ms")
    rows = losses.int8_rows(a), losses.int8_rows(b)
    print(f"int8_partial_sums over K={k}: from the tensors (laid out in "
          f"the call) {cs.median_ms(lambda: losses.int8_partial_sums(a, b)):.3f}"
          f" ms, from operands laid out once "
          f"{cs.median_ms(lambda: losses.int8_partial_sums(*rows)):.3f} ms; "
          f"laying one out {cs.median_ms(lambda: losses.int8_rows(b)):.3f} "
          f"ms")


if __name__ == "__main__":
    main()
