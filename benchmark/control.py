"""Readings that set a cell's limits, on the chip at the cell's own size:

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 \
        [--program] [--control] [--faults]

For each seed it builds the run's inputs from that seed and prints one
JSON line per reading that the cell's loop (``benchmark/loops/<loop>.py``,
its ``readings``) gives, each the cell's compared numbers against the
float32 reference (``harness.check``):

- ``program``: the program as a run drives it (train: the checked steps
  through ``Solver.step``; retrieval: one request of each pool batch
  through ``Server.forward_batch`` and ``Server.probabilities``): the
  lower readings;
- ``control``: the reference computed one precision below the one the
  configuration states (its ``control``: TF32 operands for float32, fp8
  e4m3 operands for bfloat16) in the program's place: the upper readings;
- ``fault:*``: the loop's faults, planted around the reference put in the
  program's place.

No run of the benchmark calls this. ``benchmark/tests`` runs the same
readings at a small size on the CPU."""

from __future__ import annotations

import argparse
import json
import sys
import time
import typing as tp

import torch

from .harness import cell, spec


def main(argv: tp.Optional[tp.List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    for flag in ("program", "control", "faults"):
        parser.add_argument(f"--{flag}", action="store_true")
    args = parser.parse_args(argv)
    what = [f for f in ("program", "control", "faults") if getattr(args, f)]
    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    c = spec.load_cell(spec.BENCH_DIR.parent, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for name, numbers in c.loop.readings(c, seed, device, what):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        cell.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
