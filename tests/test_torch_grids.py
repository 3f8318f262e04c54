"""The port's grid layer (``brainmagick_tpu_torch.grids``) against the JAX
package's: every grid's jobs, overrides, scheduling hints and signatures
in the same order; every job's model built by the port; the grid
searcher and the exports (CSV, HTML, sbatch, the table) as the same text
over the same histories; the runner's skip rule on the port's tagged
done-torch.json, its subprocess fan-out (return codes, logs, the data
paths the children see) and its in-process path (the job's own cache, a
resumed XP, TF32 flags and the env restored); and the rehearsal grid's
whole chain on the fake study on the CPU: train in this process and in a
subprocess, skip, tabulate, evaluate the grid and write the paper
table."""

import contextlib
import csv
import gc
import io
import json
import shlex
import sys
import weakref
from pathlib import Path

import pytest
import torch

from brainmagick_tpu.grids import explore as jexplore
from brainmagick_tpu.grids import get_grid as jget_grid
from brainmagick_tpu.grids import list_grids as jlist_grids
from brainmagick_tpu.grids import runner as jrunner
from brainmagick_tpu.grids import slurm as jslurm
from brainmagick_tpu.grids.launcher import Launcher as JLauncher
from brainmagick_tpu.grids.launcher import \
    SimpleGridSearcher as JSimpleGridSearcher
from brainmagick_tpu_torch import eval as port_eval
from brainmagick_tpu_torch import models, paper_tables
from brainmagick_tpu_torch.cache import tagged
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.grids import explore, get_grid, list_grids, runner
from brainmagick_tpu_torch.grids import slurm
from brainmagick_tpu_torch.grids.launcher import (Job, Launcher,
                                                  SimpleGridSearcher)
from brainmagick_tpu_torch.models import DeepMel, SimpleConv
from brainmagick_tpu_torch.solver import Solver
from brainmagick_tpu_torch.train import parse_overrides

REPO = Path(__file__).resolve().parents[1]
GRIDS = jlist_grids() + ["rehearsal"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(autouse=True)
def _no_rehearsal_hooks(monkeypatch):
    monkeypatch.delenv("BM_REHEARSAL_EXTRA", raising=False)
    monkeypatch.delenv("BM_REHEARSAL_CACHE", raising=False)


def test_list_grids_is_the_jax_packages():
    assert list_grids() == jlist_grids()
    assert "nmi.main_table" in list_grids() and len(list_grids()) >= 8


@pytest.mark.parametrize("name", GRIDS)
def test_grid_matches_jax(name):
    """The same jobs in the same order: overrides, slurm metadata, CLI
    tokens and signatures; main_table has 60 and ablation_final 144."""
    _, jobs = get_grid(name)
    _, jjobs = jget_grid(name)
    assert len(jobs) == len(jjobs)
    assert [j.overrides for j in jobs] == [j.overrides for j in jjobs]
    assert [j.slurm for j in jobs] == [j.slurm for j in jjobs]
    assert [j.to_tokens() for j in jobs] == [j.to_tokens() for j in jjobs]
    sigs = [j.sig for j in jobs]
    assert sigs == [j.sig for j in jjobs]
    assert len(set(sigs)) == len(sigs)
    assert len(jobs) == {"nmi.main_table": 60,
                         "nmi.ablation_final": 144}.get(name, len(jobs))


@pytest.mark.parametrize("name", GRIDS)
def test_grid_jobs_build_port_models(name):
    """Every job's config builds the port's model (and feature model) at a
    small sensor count on the CPU: no option of a paper grid raises. Jobs
    whose model options are equal build once."""
    _, jobs = get_grid(name)
    built = set()
    for job in jobs:
        cfg = job.to_config()
        key = json.dumps([cfg.model_name, cfg.simpleconv, cfg.task.type,
                          cfg.feature_model_name, cfg.feature_model_params],
                         sort_keys=True, default=str)
        if key in built:
            continue
        built.add(key)
        sensors = max(20, cfg.simpleconv["subsample_meg_channels"] + 2)
        gen = torch.Generator().manual_seed(0)
        model = models.build_model(cfg, sensors, 16, 2, "cpu", gen)
        assert isinstance(model, SimpleConv)
        assert model.hidden == {"meg": cfg.simpleconv["hidden"]}
        feature_model = models.build_feature_model(cfg, 16, "cpu", gen)
        assert (feature_model is None) == (cfg.feature_model_name is None)
        assert feature_model is None or isinstance(feature_model, DeepMel)
        mask = model.meg_mask
        if cfg.simpleconv["subsample_meg_channels"]:
            assert int(mask.sum()) == cfg.simpleconv["subsample_meg_channels"]
        else:
            assert mask is None
    assert built


def test_launcher_bind_and_dedup():
    for launcher in (Launcher(), JLauncher()):
        launcher.bind_({"model": "clip_conv"})
        sub = launcher.bind({"dset.selections": ["fake"]}, seed=1)
        job1, job2 = sub(), sub()
        assert len(launcher.jobs) == 1 and job1.sig == job2.sig
        sub({"optim.lr": 1e-3})
        sub({"feature_model": "deep_mel"})
        assert len(launcher.jobs) == 3
    port, jax_ = Launcher(), JLauncher()
    for launcher in (port, jax_):
        launcher.bind_({"model": "clip_conv"})
        launcher.bind({"dset.selections": ["fake"]}, seed=1)()
        launcher({"simpleconv.merger_dropout": 0.})
    assert [j.sig for j in port.jobs] == [j.sig for j in jax_.jobs]
    assert port.jobs[0].to_config().simpleconv["merger_pos_dim"] == 2048


def test_unknown_override_raises():
    """A key the port's config lacks raises, rather than being dropped
    from the signature."""
    with pytest.raises(ValueError, match="Unknown config key"):
        Job(overrides={"optim.no_such_key": 1}).sig
    with pytest.raises(ValueError, match="Unknown config key"):
        Job(overrides={"no_such_key": 1}).sig


def test_simple_grid_searcher_matches_jax():
    jobs = {}
    for key, (searcher, launcher) in {
            "port": (SimpleGridSearcher(), Launcher()),
            "jax": (JSimpleGridSearcher(), JLauncher())}.items():
        searcher.define_grid_param({"optim.lr": [1e-4, 3e-4],
                                    "optim.batch_size": [32, 64]})
        searcher.define_grid_param({"dset.n_subjects": [4, None]})
        searcher.define_grid_param({"seed": 7})
        jobs[key] = searcher.grid_search(launcher)
    assert len(jobs["port"]) == 4
    assert [j.overrides for j in jobs["port"]] == \
        [j.overrides for j in jobs["jax"]]
    assert [j.sig for j in jobs["port"]] == [j.sig for j in jobs["jax"]]


def _histories(out_dir, name, jax_too=True):
    """Fabricated histories for every other job of `name`: the port's
    history-torch.json and (`jax_too`) the same as the JAX package's
    history.json; returns the jobs."""
    _, jobs = get_grid(name)
    for k, job in enumerate(jobs[::2]):
        folder = Path(out_dir) / "xps" / job.sig
        folder.mkdir(parents=True, exist_ok=True)
        history = [{"train": {"loss": 3.0 - k / 7}, "valid": {"loss": 2.5}},
                   {"train": {"loss": 2.0 + k}, "valid": {"loss": 2.1 - k},
                    "test": {"wer": 0.4 + k / 3, "wer_vocab": 0.55}}]
        if k % 2:
            history = history[:1]
        names = [tagged("history.json")] + (["history.json"] if jax_too
                                            else [])
        for file_name in names:
            (folder / file_name).write_text(json.dumps(history))
    return jobs


@pytest.mark.parametrize("name", ["nmi.wordlists", "nmi.nmels"])
def test_exports_match_jax(tmp_path, name, capsys):
    """show_table, export_csv, export_html and export_sbatch over the same
    histories (the port's in history-torch.json, the JAX package's in
    history.json) write the same text, the module name and the done
    marker aside: the sbatch scripts skip the job whose folder holds the
    package's own done marker."""
    jobs = _histories(tmp_path, name)
    out = str(tmp_path)
    runner.show_table(name, out)
    got = capsys.readouterr().out
    jrunner.show_table(name, out)
    assert got == capsys.readouterr().out
    assert "2.1000" in got and jobs[-1].sig in got
    got = runner.export_csv(name, out, dest=str(tmp_path / "port.csv"))
    want = jrunner.export_csv(name, out, dest=str(tmp_path / "jax.csv"))
    assert got.read_text() == want.read_text()
    assert "valid.best" in got.read_text()
    got = explore.export_html(name, out, dest=str(tmp_path / "port.html"))
    want = jexplore.export_html(name, out, dest=str(tmp_path / "jax.html"))
    assert got.read_text() == want.read_text()
    assert explore.collect_rows(name, out) == jexplore.collect_rows(name, out)

    (tmp_path / "xps" / jobs[0].sig / tagged("done.json")).write_text("{}")
    (tmp_path / "xps" / jobs[0].sig / "done.json").write_text("{}")
    (tmp_path / "xps" / jobs[-1].sig).mkdir(exist_ok=True)
    (tmp_path / "xps" / jobs[-1].sig / "done.json").write_text("{}")
    kwargs = dict(partition="gpu", time="12:00:00", gpus_per_task=1)
    got = slurm.export_sbatch(name, out, dest=str(tmp_path / "p.sbatch"),
                              **kwargs).read_text()
    (tmp_path / "xps" / jobs[-1].sig / "done.json").unlink()
    (tmp_path / "xps" / jobs[-1].sig / tagged("done.json")).write_text("{}")
    want = jslurm.export_sbatch(name, out, dest=str(tmp_path / "j.sbatch"),
                                **kwargs).read_text()
    commands = [" ".join(map(shlex.quote, runner._job_command(job, out)))
                for job in jobs]
    assert commands[0] not in got and commands[-1] in got
    assert got.count(";;") == len(jobs)
    assert got.replace("brainmagick_tpu_torch.train",
                       "brainmagick_tpu.train") == want
    assert "#SBATCH --gpus-per-task=1" in got


def test_exports_read_only_the_ports_files(tmp_path, capsys):
    """A folder that holds only the JAX package's history.json and
    done.json is untrained for the port's table, CSV and sbatch."""
    name = "nmi.wordlists"
    jobs = _histories(tmp_path, name)
    for job in jobs[::2]:
        (tmp_path / "xps" / job.sig / tagged("history.json")).unlink()
        (tmp_path / "xps" / job.sig / "done.json").write_text("{}")
    runner.show_table(name, str(tmp_path))
    table = capsys.readouterr().out
    assert "2.1000" not in table and table.count(" -  ") >= len(jobs)
    text = runner.export_csv(name, str(tmp_path)).read_text()
    assert "valid.loss" not in text
    script = slurm.export_sbatch(name, str(tmp_path)).read_text()
    assert script.count(";;") == len(jobs) + 1


def _fake_commands(monkeypatch, code):
    monkeypatch.setattr(runner, "_job_command",
                        lambda job, out_dir: [sys.executable, "-c", code])


def test_run_jobs_skips_on_done_torch_json(tmp_path, monkeypatch):
    """With several workers, each job runs in a subprocess logging to
    logs/<sig>.log; a folder with the JAX package's done.json runs, one
    with done-torch.json is skipped (None), and force reruns it."""
    jobs = [Job(overrides={"optim.lr": lr}) for lr in (1e-4, 2e-4, 3e-4)]
    for job, marker in zip(jobs, ("done.json", tagged("done.json"))):
        folder = tmp_path / "xps" / job.sig
        folder.mkdir(parents=True)
        (folder / marker).write_text('{"epochs": 2}')
    _fake_commands(monkeypatch, "print('ran')")
    results = runner.run_jobs(jobs, out_dir=str(tmp_path), workers=2)
    assert results == {jobs[0].sig: 0, jobs[1].sig: None, jobs[2].sig: 0}
    assert (tmp_path / "logs" / f"{jobs[0].sig}.log").read_text() == "ran\n"
    results = runner.run_jobs(jobs, out_dir=str(tmp_path), workers=2,
                              force=True)
    assert set(results.values()) == {0}


def test_run_jobs_returns_the_childs_code(tmp_path, monkeypatch):
    """A child's failure is its return code in the result, and the CLI's
    --run exits non-zero for it."""
    jobs = [Job(overrides={"optim.lr": lr}) for lr in (1e-4, 2e-4)]
    _fake_commands(monkeypatch, "import sys; sys.exit(3)")
    results = runner.run_jobs(jobs, out_dir=str(tmp_path), workers=2)
    assert results == {job.sig: 3 for job in jobs}
    with pytest.raises(SystemExit, match="1 of 1 jobs failed"):
        runner.main(["rehearsal", "--run", "--workers=2",
                     f"--out_dir={tmp_path}"])


def test_children_see_the_data_paths(tmp_path, monkeypatch):
    """The children's environment carries the paths of this process's
    env (BM_TPU_CACHE, BM_TPU_STUDY_<NAME>), set for a while or not."""
    code = ("import os; print(os.environ.get('BM_TPU_CACHE'), "
            "os.environ.get('BM_TPU_STUDY_GWILLIAMS2022'))")
    results = runner.run_commands_with_logs(
        [("a", [sys.executable, "-c", code])], tmp_path / "l0", 1)
    before = (tmp_path / "l0" / "a.log").read_text()
    with env.temporary(cache=tmp_path / "c",
                       studies={"gwilliams2022": tmp_path / "g"}):
        results = runner.run_commands_with_logs(
            [("a", [sys.executable, "-c", code])], tmp_path / "l1", 1)
    assert results == {"a": 0}
    assert (tmp_path / "l1" / "a.log").read_text() == \
        f"{tmp_path / 'c'} {tmp_path / 'g'}\n"
    assert before == f"{env.cache} " \
        f"{env.studies.get('gwilliams2022')}\n"


#: tests/test_torch_epochs.py's TINY as overrides of a job
TINY = {"dset.selections": ["fake"], "dset.n_recordings": 2,
        "dset.features": ["MelSpectrum"],
        "dset.features_params": {"MelSpectrum": {"n_mels": 8}},
        "dset.condition": 1.0, "dset.tmin": -0.2, "dset.tmax": 1.0,
        "dset.test_ratio": 0.3, "dset.valid_ratio": 0.2,
        "dset.min_n_blocks_per_split": 1, "optim.loss": "clip",
        "optim.batch_size": 8, "optim.lr": 0.001, "seed": 1234,
        "task.offset_meg_ms": 50, "test.wer_negatives": 50,
        "test.wer_topx": 3, "num_workers": 2, "device": "cpu",
        "preset": ["tiny"]}


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_run_jobs_in_process_resumes(tmp_path, monkeypatch):
    """One worker: the job trains in this process with its own cache
    (the ambient env's is another, and comes back after), the TF32 flags
    as they were, into done-torch.json and history-torch.json (no JAX
    file). A run interrupted after its first epoch's checkpoint has no
    done-torch.json, so the runner resumes it: the second run trains the
    second epoch only, on the first's history, and leaves no solver
    alive (so a card's memory comes back between XPs)."""
    cache = tmp_path / "fake_cache"
    cache.mkdir()
    job = Job(overrides={**TINY, "optim.epochs": 2, "cache": str(cache)})
    out = str(tmp_path / "out")
    folder = tmp_path / "out" / "xps" / job.sig
    commit = Solver.commit

    def commit_then_stop(solver):
        commit(solver)
        raise KeyboardInterrupt("stopped after the first epoch")
    monkeypatch.setattr(Solver, "commit", commit_then_stop)
    flags = _flags()
    ambient = tmp_path / "ambient"
    with env.temporary(cache=ambient):
        with pytest.raises(KeyboardInterrupt):
            runner.run_jobs([job], out_dir=out, workers=1)
        assert env.cache == ambient
    assert _flags() == flags
    assert not (folder / tagged("done.json")).exists()
    first = json.loads((folder / tagged("history.json")).read_text())
    assert len(first) == 1
    assert any(cache.iterdir()) and not ambient.exists()
    monkeypatch.setattr(Solver, "commit", commit)
    epochs, solvers = [], []
    run_one = Solver._run_one_epoch

    def counted(solver, train):
        if train:
            epochs.append(solver.epoch)
            solvers.append(weakref.ref(solver))
        return run_one(solver, train)
    monkeypatch.setattr(Solver, "_run_one_epoch", counted)
    assert runner.run_jobs([job], out_dir=out, workers=1) == {job.sig: 0}
    assert epochs == [2]
    # nothing keeps the XP's solver (its model, data, optimizer) alive
    gc.collect()
    assert solvers[0]() is None
    history = json.loads((folder / tagged("history.json")).read_text())
    assert len(history) == 2 and history[0] == first[0]
    assert sorted(p.name for p in folder.iterdir()) == [
        "checkpoint-torch.pt", "done-torch.json", "history-torch.json"]
    assert runner.run_jobs([job], out_dir=out, workers=1) == {job.sig: None}
    assert _flags() == flags


#: the rehearsal grid on the fake study at tiny widths, on the CPU
REHEARSAL_EXTRA = {**{k: v for k, v in TINY.items() if k != "preset"},
                   "model": "tiny", "dset.n_recordings": 2,
                   "optim.epochs": 1, "optim.max_batches": 3,
                   "test.wer_negatives": 50}


def test_rehearsal_chain_on_the_fake_study(tmp_path, monkeypatch, capsys):
    """The rehearsal grid (clip_conv_tpu, here with the tiny preset on
    top, on the fake study, on the CPU): one variant trained by
    ``run_jobs`` in this process, a second with subsample_meg_channels
    through ``--run --workers=2`` (a subprocess), a second --run that
    skips both, --table, --sbatch; ``eval grid=rehearsal`` in this
    process for one and with workers=2 for the other; then the paper
    table of each, its accuracy in [0, 1]."""
    cache = tmp_path / "fake_cache"
    cache.mkdir()
    out = str(tmp_path / "outputs")
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("BM_REHEARSAL_CACHE", str(cache))
    variants = [REHEARSAL_EXTRA,
                {**REHEARSAL_EXTRA, "simpleconv.subsample_meg_channels": 8}]

    def grid(extra):
        monkeypatch.setenv("BM_REHEARSAL_EXTRA", json.dumps(extra))
        _, jobs = get_grid("rehearsal")
        assert len(jobs) == 1
        return jobs[0]
    base, sub = (grid(extra) for extra in variants)
    cfg = base.to_config()
    assert cfg.simpleconv["fused_head"] and cfg.simpleconv["hidden"] == 24
    assert cfg.cache == str(cache)

    grid(variants[0])
    assert runner.run_jobs([base], out_dir=out) == {base.sig: 0}
    grid(variants[1])
    runner.main(["rehearsal", "--run", "--workers=2", f"--out_dir={out}"])
    for job in (base, sub):
        assert runner.is_done(out, job.sig)
        assert not (Path(out) / "xps" / job.sig / "done.json").exists()
    assert (Path(out) / "logs" / f"{sub.sig}.log").exists()
    capsys.readouterr()
    for extra in variants:
        grid(extra)
        runner.main(["rehearsal", "--run", "--workers=2",
                     f"--out_dir={out}"])
        assert "skipping" in capsys.readouterr().out
        runner.main(["rehearsal", "--table", f"--out_dir={out}"])
        table = capsys.readouterr().out
        assert "wer_vocab" in table and "1" in table.splitlines()[1]
    runner.main(["rehearsal", "--sbatch", "--force", f"--out_dir={out}"])
    script = (Path(out) / "grid_rehearsal.sbatch").read_text()
    assert "brainmagick_tpu_torch.train" in script
    assert "simpleconv.subsample_meg_channels=8" in script

    with env.temporary(cache=cache):
        grid(variants[0])
        accs = port_eval.main(["grid=rehearsal", f"out_dir={out}",
                               "device=cpu", "n_negatives=50"])
        assert list(accs) == [base.sig] and sorted(accs[base.sig]) == \
            [1, 5, 10]
        grid(variants[1])
        codes = port_eval.main(["grid=rehearsal", f"out_dir={out}",
                                "device=cpu", "workers=2"])
        assert codes == {sub.sig: 0}
    assert (Path(out) / "eval" / "logs" / f"{sub.sig}.log").exists()
    for extra, job in zip(variants, (base, sub)):
        assert (Path(out) / "eval" / tagged(job.sig) / "acc.csv").exists()
        grid(extra)
        dest = paper_tables.main(["table", "grid=rehearsal",
                                  f"out_dir={out}"])
        with open(dest) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 1 and rows[0]["dataset"] == "fake"
        assert rows[0]["count"] == "1" and rows[0]["std"] == ""
        assert 0 <= float(rows[0]["mean"]) <= 1
        assert 0 <= float(rows[0]["acc_pct"]) <= 100


def test_the_cli_lists_a_grid():
    """``python -m brainmagick_tpu_torch.grids nmi.main_table`` in a
    subprocess prints the 60 jobs."""
    import subprocess
    out = subprocess.run([sys.executable, "-m", "brainmagick_tpu_torch.grids",
                          "nmi.main_table"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 60
    assert lines[0].split()[0] == jget_grid("nmi.main_table")[1][0].sig


def test_parse_overrides_is_the_launchers():
    job = Job(overrides={"preset": ["clip_conv", "deep_mel"],
                         "dset.features_params.MelSpectrum.n_mels": 40,
                         "norm.max_scale": 1e12})
    assert job.to_tokens()[:2] == ["preset=clip_conv", "preset=deep_mel"]
    cfg = parse_overrides(job.to_tokens())
    assert cfg.sig == job.sig
    assert cfg.dset.features_params["MelSpectrum"]["n_mels"] == 40
    with contextlib.redirect_stdout(io.StringIO()):
        assert runner.main(["nmi.wordlists"]) is None
