"""Budgeted hyperparameter search, no external dependencies.

Port of ``brainmagick_tpu/grids/sweep.py``, the role of the reference's
hydra Nevergrad sweeper template (a budgeted search over a
parametrization of config keys, optimizing one metric with N workers):
a self-contained random-search driver over the grid runner. Every trial
is an ordinary XP (resumable through done-torch.json, per-trial logs,
shared cache), and the objective is read from each XP's
history-torch.json, so a killed sweep re-launched with the same seed
skips finished trials and continues. The trials are the JAX package's
for the same space and seed (the same ``RandomState`` draws), and
sweep_results.csv is written as pandas writes it.

Space forms mirror the template's parametrization:

    {
      "optim.lr":          {"lower": 1e-5, "upper": 1e-2, "log": true,
                            "init": 3e-4},
      "simpleconv.depth":  {"lower": 2, "upper": 10, "integer": true},
      "optim.loss":        ["clip", "mse"],          # choice
      "optim.batch_size":  {"value": 256}            # pinned
    }

The FIRST trial is the init point (each key's `init`, first choice, or
the space midpoint), so the baseline configuration is always part of
the sweep.

CLI:
    python -m brainmagick_tpu_torch.grids.sweep space.json --budget=20 \
        --workers=2 --metric=valid.loss [--maximize] [--seed=0] \
        [--out_dir=./outputs] [base overrides, e.g. preset=clip_conv]
"""

from __future__ import annotations

import ast
import json
import logging
import sys
import typing as tp
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils import records_csv, write_and_rename
from .launcher import Job

logger = logging.getLogger(__name__)


@dataclass
class Scalar:
    lower: float
    upper: float
    log: bool = False
    integer: bool = False
    init: tp.Optional[float] = None

    def sample(self, rng: np.random.RandomState) -> tp.Any:
        if self.log:
            assert self.lower > 0, "log scale needs a positive lower bound"
            val = float(np.exp(rng.uniform(np.log(self.lower),
                                           np.log(self.upper))))
        else:
            val = float(rng.uniform(self.lower, self.upper))
        return int(round(val)) if self.integer else val

    def midpoint(self) -> tp.Any:
        if self.init is not None:
            return int(round(self.init)) if self.integer else self.init
        if self.log:
            mid = float(np.exp((np.log(self.lower) + np.log(self.upper))
                               / 2))
        else:
            mid = (self.lower + self.upper) / 2
        return int(round(mid)) if self.integer else mid


@dataclass
class Choice:
    options: tp.List[tp.Any]
    init: tp.Optional[tp.Any] = None

    def sample(self, rng: np.random.RandomState) -> tp.Any:
        return self.options[rng.randint(len(self.options))]

    def midpoint(self) -> tp.Any:
        return self.init if self.init is not None else self.options[0]


@dataclass
class Fixed:
    value: tp.Any

    def sample(self, rng: np.random.RandomState) -> tp.Any:
        return self.value

    def midpoint(self) -> tp.Any:
        return self.value


Spec = tp.Union[Scalar, Choice, Fixed]


def parse_space(raw: tp.Mapping[str, tp.Any]) -> tp.Dict[str, Spec]:
    """JSON space description -> specs (forms documented above)."""
    space: tp.Dict[str, Spec] = {}
    for key, desc in raw.items():
        if isinstance(desc, list):
            space[key] = Choice(desc)
        elif isinstance(desc, dict) and "options" in desc:
            space[key] = Choice(list(desc["options"]),
                                init=desc.get("init"))
        elif isinstance(desc, dict) and "value" in desc:
            space[key] = Fixed(desc["value"])
        elif isinstance(desc, dict) and "lower" in desc:
            space[key] = Scalar(
                lower=float(desc["lower"]), upper=float(desc["upper"]),
                log=bool(desc.get("log", False)),
                integer=bool(desc.get("integer", False)),
                init=desc.get("init"))
        else:
            raise ValueError(f"unrecognized space entry {key}: {desc!r}")
    return space


def sample_trials(space: tp.Mapping[str, Spec], budget: int,
                  seed: int = 0) -> tp.List[tp.Dict[str, tp.Any]]:
    """Deterministic trial list: the init point first, then random
    samples; duplicates (same override dict) are skipped, drawing until
    `budget` distinct trials or the draw limit is hit."""
    rng = np.random.RandomState(seed)
    trials: tp.List[tp.Dict[str, tp.Any]] = []
    seen: tp.Set[str] = set()

    def push(point: tp.Dict[str, tp.Any]) -> None:
        key = json.dumps(point, sort_keys=True, default=str)
        if key not in seen:
            seen.add(key)
            trials.append(point)

    push({k: spec.midpoint() for k, spec in space.items()})
    draws = 0
    while len(trials) < budget and draws < budget * 50:
        push({k: spec.sample(rng) for k, spec in space.items()})
        draws += 1
    return trials[:budget]


def objective_from_history(history: tp.Sequence[tp.Mapping[str, tp.Any]],
                           metric: str) -> tp.Optional[tp.List[float]]:
    """`metric` is a dotted stage.key into the per-epoch history
    entries (e.g. 'valid.loss', 'test.wer_vocab'); returns the series
    of values (missing epochs skipped) — callers take min/max."""
    stage, _, key = metric.partition(".")
    values = [float(entry[stage][key]) for entry in history
              if stage in entry and key in entry[stage]]
    if not values:
        return None
    return values


def run_sweep(space: tp.Mapping[str, Spec], budget: int,
              base_overrides: tp.Optional[tp.Mapping[str, tp.Any]] = None,
              out_dir: str = "./outputs", workers: int = 1,
              metric: str = "valid.loss", maximize: bool = False,
              seed: int = 0) -> tp.List[tp.Dict[str, tp.Any]]:
    """Run the sweep and return trials sorted best-first; also writes
    <out_dir>/sweep_results.csv."""
    from . import runner

    trials = sample_trials(space, budget, seed=seed)
    jobs = [Job(overrides={**dict(base_overrides or {}), **point})
            for point in trials]
    runner.run_jobs(jobs, out_dir=out_dir, workers=workers)

    results = []
    for point, job in zip(trials, jobs):
        sig = job.sig
        row: tp.Dict[str, tp.Any] = {"sig": sig, **point}
        history = runner.read_history(out_dir, sig)
        row["objective"] = None
        if history is not None:
            values = objective_from_history(history, metric)
            if values:
                row["objective"] = max(values) if maximize else min(values)
        results.append(row)

    scored = [r for r in results if r["objective"] is not None]
    failed = [r for r in results if r["objective"] is None]
    scored.sort(key=lambda r: r["objective"], reverse=maximize)
    results = scored + failed

    with write_and_rename(Path(out_dir) / "sweep_results.csv", "w") as f:
        f.write(records_csv(results))
    if scored:
        logger.info("sweep best %s=%s: %s", metric,
                    scored[0]["objective"], scored[0])
    return results


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    tokens = list(argv if argv is not None else sys.argv[1:])
    if not tokens or tokens[0] in ("-h", "--help"):
        print(__doc__)
        return
    space_path, flags, base = tokens[0], {}, {}
    for token in tokens[1:]:
        if token.startswith("--"):
            key, _, val = token[2:].partition("=")
            flags[key] = val if val else "true"
        else:
            # parse base-override values like the train CLI does, so
            # list/dict literals survive the Job round-trip
            key, _, val = token.partition("=")
            try:
                base[key] = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                base[key] = val
    with open(space_path) as f:
        space = parse_space(json.load(f))
    results = run_sweep(
        space, budget=int(flags.get("budget", 16)),
        base_overrides=base, out_dir=flags.get("out_dir", "./outputs"),
        workers=int(flags.get("workers", 1)),
        metric=flags.get("metric", "valid.loss"),
        maximize=flags.get("maximize", "false").lower() == "true",
        seed=int(flags.get("seed", 0)))
    for row in results[:10]:
        print(row)


if __name__ == "__main__":
    main()
