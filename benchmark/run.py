"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result's JSON object; the
numbers that decided ``correct`` follow each beside its limit as the last
lines of standard error. Without CUDA, or with fewer cards than the cell
asks for, it exits 2 and prints no result; a run that finds ``jax``,
``jaxlib``, ``flax``, ``optax`` or the JAX package among its modules
exits 3 and prints none either. Build and kernel caches go to fixed
folders under ``.bench_cache/`` in the checkout."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import typing  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
#: fixed cache folders in the checkout, by the variable that names each
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
          ("CUDA_CACHE_PATH", "cuda"))


def cache_env() -> None:
    """Point every build and kernel cache at ``.bench_cache/`` in the
    checkout, and keep ``transformers`` from loading flax; before torch
    is imported."""
    for var, name in CACHES:
        os.environ[var] = str(ROOT / ".bench_cache" / name)
    os.environ["USE_FLAX"] = "0"


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv: typing.Optional[typing.List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_env()

    from benchmark.harness import spec

    entries = {w["name"]: w for w in spec.benchmark(ROOT)["workloads"]}
    if args.workload not in entries:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = entries[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    from benchmark.harness import cell

    print(f"card: {card()}", file=sys.stderr)
    try:
        result = cell.run(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T_START)
        cell.check_modules()
    except cell.ForbiddenModules as exc:
        print(str(exc), file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, value in result["diagnostics"].items():
        print(f"diagnostic {name} {value!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
