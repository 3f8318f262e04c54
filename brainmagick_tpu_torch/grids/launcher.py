"""Launcher and explorer abstractions (Dora-free).

Port of ``brainmagick_tpu/grids/launcher.py``, building each job's config
on the port's ``config.MainConfig`` with the port's
``train.parse_overrides``, so a job's signature is the JAX package's for
the same overrides. The API is the one the grid files use: ``bind``
returns a sub-launcher with extra overrides, ``bind_`` adds them in
place, calling the launcher schedules one XP (identical XPs, by
signature, once), ``job_array()`` groups jobs and ``slurm_`` records
scheduling hints as metadata.
"""

from __future__ import annotations

import contextlib
import itertools
import typing as tp
from dataclasses import dataclass, field

from ..config import MainConfig
from ..train import parse_overrides


def _merge(base: tp.Dict[str, tp.Any],
           overrides: tp.Mapping[str, tp.Any]) -> None:
    """Merge overrides into base; `model=`/`feature_model=` keys compose
    as presets (like dora config groups) and accumulate in a list."""
    for key, val in overrides.items():
        if key in ("model", "feature_model"):
            presets = list(base.get("preset", []))
            if val not in presets:
                presets.append(val)
            base["preset"] = presets
        else:
            base[key] = val


@dataclass
class Job:
    overrides: tp.Dict[str, tp.Any]
    slurm: tp.Dict[str, tp.Any] = field(default_factory=dict)

    def to_tokens(self) -> tp.List[str]:
        """CLI override tokens (the strings ``python -m
        brainmagick_tpu_torch.train`` accepts): the presets first, since
        they set whole groups, then each override as ``key=repr(value)``."""
        tokens = []
        items = sorted(self.overrides.items(),
                       key=lambda kv: kv[0] != "preset")
        for key, val in items:
            if key == "preset":
                for preset in (val if isinstance(val, list) else [val]):
                    tokens.append(f"preset={preset}")
            else:
                tokens.append(f"{key}={val!r}")
        return tokens

    def to_config(self, base: tp.Optional[MainConfig] = None) -> MainConfig:
        return parse_overrides(self.to_tokens(), base or MainConfig())

    @property
    def sig(self) -> str:
        return self.to_config().sig


class Launcher:
    """Collects jobs; `bind` layers overrides hierarchically."""

    def __init__(self, jobs: tp.Optional[tp.List[Job]] = None,
                 overrides: tp.Optional[tp.Dict[str, tp.Any]] = None,
                 slurm: tp.Optional[tp.Dict[str, tp.Any]] = None) -> None:
        self.jobs: tp.List[Job] = jobs if jobs is not None else []
        self._overrides = dict(overrides or {})
        self._slurm = dict(slurm or {})
        self._seen: tp.Set[str] = set()

    def _merged(self, override_dicts: tp.Sequence[tp.Mapping[str, tp.Any]],
                kwargs: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
        merged = dict(self._overrides)
        merged["preset"] = list(merged.get("preset", []))
        for d in override_dicts:
            _merge(merged, d)
        _merge(merged, kwargs)
        return merged

    def bind(self, *override_dicts: tp.Mapping[str, tp.Any],
             **kwargs: tp.Any) -> "Launcher":
        child = Launcher(self.jobs, self._merged(override_dicts, kwargs),
                         self._slurm)
        child._seen = self._seen
        return child

    def bind_(self, *override_dicts: tp.Mapping[str, tp.Any],
              **kwargs: tp.Any) -> None:
        for d in override_dicts:
            _merge(self._overrides, d)
        _merge(self._overrides, kwargs)

    def slurm_(self, **kwargs: tp.Any) -> None:
        self._slurm.update(kwargs)

    @contextlib.contextmanager
    def job_array(self) -> tp.Iterator[None]:
        yield  # grouping hint only; jobs run wherever the runner decides

    def __call__(self, *override_dicts: tp.Mapping[str, tp.Any],
                 **kwargs: tp.Any) -> Job:
        merged = self._merged(override_dicts, kwargs)
        if not merged["preset"]:
            del merged["preset"]
        job = Job(overrides=merged, slurm=dict(self._slurm))
        sig = job.sig
        if sig not in self._seen:  # dedup identical XPs (dora semantics)
            self._seen.add(sig)
            self.jobs.append(job)
        return job


class SimpleGridSearcher:
    """Naive grid search over parameter groups.

    Values given in the same `define_grid_param` call vary together
    (zipped); separate calls are crossed. Non-list values are constants;
    None drops the key for that combination.

        searcher = SimpleGridSearcher()
        searcher.define_grid_param({"optim.lr": [1e-4, 3e-4]})
        searcher.define_grid_param({"dset.n_subjects": [4, None]})
        searcher.grid_search(launcher)
    """

    def __init__(self) -> None:
        self._groups: tp.List[tp.List[tp.Dict[str, tp.Any]]] = []

    def define_grid_param(self, args_dict: tp.Mapping[str, tp.Any]) -> None:
        lists = {k: (v if isinstance(v, list) else [v])
                 for k, v in args_dict.items()}
        lengths = {len(v) for v in lists.values()}
        assert len(lengths) == 1, \
            "params in one group must have the same number of values"
        group = []
        for idx in range(lengths.pop()):
            combo = {k: v[idx] for k, v in lists.items()}
            group.append({k: v for k, v in combo.items() if v is not None})
        self._groups.append(group)

    def grid_search(self, launcher: Launcher) -> tp.List[Job]:
        jobs = []
        for combos in itertools.product(*self._groups):
            merged: tp.Dict[str, tp.Any] = {}
            for combo in combos:
                merged.update(combo)
            jobs.append(launcher(merged))
        return jobs


class Explorer:
    """Decorator recording the grid function and its metric table."""

    test_metrics: tp.List[str] = []

    def __init__(self, fn: tp.Callable[[Launcher], None]) -> None:
        self.fn = fn
        self.__name__ = fn.__name__

    def __call__(self, launcher: Launcher) -> None:
        self.fn(launcher)

    def process_history(self, history: tp.List[dict]) -> dict:
        """history-torch.json's entries -> one summary dict per XP: the
        last value of each stage's metric, the epoch count, and the best
        valid loss so far."""
        stages: tp.Dict[str, tp.Dict[str, tp.Any]] = {
            "train": {"epoch": len(history)}}
        best = float("inf")
        for metrics in history:
            for stage_name, stage_metrics in metrics.items():
                stages.setdefault(stage_name, {}).update(stage_metrics)
            if "valid" in stages and "loss" in stages["valid"]:
                best = min(best, stages["valid"]["loss"])
                stages["valid"]["best"] = best
        return stages

    def table_row(self, sig: str, history: tp.List[dict]) -> tp.Dict[str, str]:
        stages = self.process_history(history)
        nan = float("nan")
        row = {"sig": sig,
               "epoch": str(stages["train"].get("epoch", "")),
               "train": f"{stages['train'].get('loss', nan):.4f}",
               "valid": f"{stages.get('valid', {}).get('loss', nan):.4f}",
               "best": f"{stages.get('valid', {}).get('best', nan):.4f}"}
        for name in self.test_metrics:
            val = stages.get("test", {}).get(name)
            row[name] = f"{val:.3f}" if val is not None else "-"
        return row


class BMExplorer(Explorer):
    test_metrics: tp.List[str] = []


class ClipExplorer(BMExplorer):
    test_metrics = ["wer", "wer_vocab"]
