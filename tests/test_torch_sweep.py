"""The port's budgeted sweep (``brainmagick_tpu_torch.grids.sweep``)
against the JAX package's: the parsed space, the sampled trials (the same
``RandomState`` draws), the objective series, and ``run_sweep``'s ranking
and sweep_results.csv text (written without pandas) with each package's
``run_jobs`` mocked to write the same histories, the port's in
history-torch.json."""

import json
from pathlib import Path

import pytest

from brainmagick_tpu.grids import runner as jrunner
from brainmagick_tpu.grids import sweep as jsweep
from brainmagick_tpu_torch.cache import tagged
from brainmagick_tpu_torch.grids import runner, sweep

SPACES = {
    "mixed": {"optim.lr": {"lower": 1e-5, "upper": 1e-2, "log": True,
                           "init": 3e-4},
              "simpleconv.depth": {"lower": 2, "upper": 10,
                                   "integer": True},
              "optim.loss": ["clip", "mse"],
              "optim.batch_size": {"value": 64}},
    "choices": {"dset.features": {"options": [["MelSpectrum"],
                                              ["Wav2VecTransformer"]],
                                  "init": ["MelSpectrum"]},
                "simpleconv.merger": [True, False],
                "norm.max_scale": {"lower": 10, "upper": 100}},
    "one": {"optim.lr": {"lower": 1e-4, "upper": 1e-2, "log": True}},
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("space", list(SPACES))
def test_space_and_trials_match_jax(space, seed):
    got = sweep.parse_space(SPACES[space])
    want = jsweep.parse_space(SPACES[space])
    assert [type(s).__name__ for s in got.values()] == \
        [type(s).__name__ for s in want.values()]
    assert [vars(s) for s in got.values()] == [vars(s) for s in want.values()]
    for budget in (1, 6, 40):
        trials = sweep.sample_trials(got, budget, seed=seed)
        assert trials == jsweep.sample_trials(want, budget, seed=seed)
        assert [type(v) for t in trials for v in t.values()] == [
            type(v) for t in jsweep.sample_trials(want, budget, seed=seed)
            for v in t.values()]
    with pytest.raises(ValueError, match="unrecognized"):
        sweep.parse_space({"x": {"bogus": 1}})


def test_objective_from_history_matches_jax():
    history = [{"train": {"loss": 3.0}, "valid": {"loss": 2.5}},
               {"train": {"loss": 2.0}, "valid": {"loss": 2.1},
                "test": {"wer": 0.4}},
               {"train": {"loss": 1.5}, "valid": {"loss": 2.3}}]
    for metric in ("valid.loss", "test.wer", "test.missing", "train.loss"):
        assert sweep.objective_from_history(history, metric) == \
            jsweep.objective_from_history(history, metric)


def _fake_run_jobs(out_dir, file_name, calls):
    """A run_jobs that writes each trial a history (`file_name`) whose
    valid loss follows its lr and its loss choice; the third trial
    "crashes" (no history)."""
    def run_jobs(jobs, out_dir=out_dir, workers=1, force=False):
        calls.append((len(jobs), workers))
        for k, job in enumerate(jobs):
            if k == 2:
                continue
            folder = Path(out_dir) / "xps" / job.sig
            folder.mkdir(parents=True, exist_ok=True)
            loss = float(job.overrides.get("optim.lr", 1e-3)) * 1e3 \
                + (job.overrides.get("optim.loss") == "mse") / 3
            with open(folder / file_name, "w") as f:
                json.dump([{"valid": {"loss": loss + 1.0}},
                           {"valid": {"loss": loss}, "test": {"wer": k}}], f)
        return {job.sig: 0 for job in jobs}
    return run_jobs


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("space", list(SPACES))
def test_run_sweep_matches_jax(tmp_path, monkeypatch, space, maximize):
    """Both packages' run_sweep over the same space, base overrides and
    seed, each runner mocked: the same ranked rows (failed trials last)
    and the same sweep_results.csv text."""
    base = {"preset": ["clip_conv"], "dset.selections": ["fake"]}
    metric = "test.wer" if maximize else "valid.loss"
    results, calls = {}, []
    for name, module, run_mod, file_name in (
            ("port", sweep, runner, tagged("history.json")),
            ("jax", jsweep, jrunner, "history.json")):
        out = tmp_path / name
        monkeypatch.setattr(run_mod, "run_jobs",
                            _fake_run_jobs(out, file_name, calls))
        results[name] = module.run_sweep(
            module.parse_space(SPACES[space]), budget=5,
            base_overrides=base, out_dir=str(out), workers=3,
            metric=metric, maximize=maximize, seed=3)
        results[name + "_csv"] = (out / "sweep_results.csv").read_text()
    assert calls[0] == calls[1] == (len(results["port"]), 3)
    assert results["port"] == results["jax"]
    assert results["port_csv"] == results["jax_csv"]
    objectives = [r["objective"] for r in results["port"]]
    if len(objectives) > 2:
        assert None in objectives and objectives[-1] is None


def test_run_sweep_reads_only_the_ports_history(tmp_path, monkeypatch):
    """A trial whose folder holds only the JAX package's history.json has
    no objective for the port."""
    monkeypatch.setattr(runner, "run_jobs", _fake_run_jobs(
        tmp_path, "history.json", []))
    results = sweep.run_sweep(sweep.parse_space(SPACES["one"]), budget=2,
                              out_dir=str(tmp_path))
    assert [r["objective"] for r in results] == [None, None]
    assert (tmp_path / "sweep_results.csv").read_text().endswith(",\n")


def test_cli_parses_like_jax(tmp_path, monkeypatch):
    """``python -m brainmagick_tpu_torch.grids.sweep space.json --budget
    --workers --metric --seed [base overrides]``: the same jobs reach the
    runner as the JAX CLI's."""
    space = tmp_path / "space.json"
    space.write_text(json.dumps(SPACES["mixed"]))
    seen = {}
    for name, module, run_mod in (("port", sweep, runner),
                                  ("jax", jsweep, jrunner)):
        def run_jobs(jobs, out_dir, workers=1, force=False, name=name):
            seen[name] = ([job.overrides for job in jobs], out_dir, workers)
            return {}
        monkeypatch.setattr(run_mod, "run_jobs", run_jobs)
        module.main([str(space), "--budget=4", "--workers=2", "--seed=5",
                     f"--out_dir={tmp_path}", "--metric=valid.loss",
                     "preset=clip_conv", 'dset.selections=["fake"]',
                     "optim.epochs=3"])
    assert seen["port"] == seen["jax"]
    assert len(seen["port"][0]) == 4 and seen["port"][2] == 2
    assert seen["port"][0][0]["dset.selections"] == ["fake"]
