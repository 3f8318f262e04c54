"""Grid runner: resolve a grid module, list / run its jobs, show the
metric table (replaces `dora grid <name>`).

Port of ``brainmagick_tpu/grids/runner.py``. Usage:

    python -m brainmagick_tpu_torch.grids nmi.main_table          # list jobs
    python -m brainmagick_tpu_torch.grids nmi.main_table --run    # run here
    python -m brainmagick_tpu_torch.grids nmi.main_table --run --workers=4
    python -m brainmagick_tpu_torch.grids nmi.main_table --table  # metrics
    python -m brainmagick_tpu_torch.grids nmi.main_table --csv | --html
    python -m brainmagick_tpu_torch.grids nmi.main_table --sbatch \
        [--partition=...] [--time=...] [--cpus_per_task=...] \
        [--gpus_per_task=...]

Every command takes --out_dir=... (./outputs by default). With
--workers=N, N jobs run at once as subprocesses of ``python -m
brainmagick_tpu_torch.train`` with per-job logs under
<out_dir>/logs/<sig>.log; with one worker they run one after the other
in this process. The port's XP files carry its tag: an XP is trained
when its folder holds done-torch.json (the JAX package's done.json does
not count), interrupted runs resume from their checkpoint-torch.pt, and
--force reruns finished ones. A --run whose jobs fail exits non-zero.
"""

from __future__ import annotations

import gc
import importlib
import json
import logging
import pkgutil
import sys
import typing as tp
from pathlib import Path

import torch

from ..cache import tagged
from ..env import env
from .launcher import Explorer, Job, Launcher

logger = logging.getLogger(__name__)

#: the port's files in an XP folder, beside the JAX package's untagged ones
DONE = tagged("done.json")
HISTORY = tagged("history.json")


def list_grids() -> tp.List[str]:
    from . import nmi
    return [f"nmi.{mod.name}" for mod in pkgutil.iter_modules(nmi.__path__)]


def get_grid(name: str) -> tp.Tuple[Explorer, tp.List[Job]]:
    module = importlib.import_module(f"brainmagick_tpu_torch.grids.{name}")
    explorer = module.explorer
    assert isinstance(explorer, Explorer), \
        f"grid {name} must define an @Explorer-decorated `explorer`"
    launcher = Launcher()
    explorer(launcher)
    return explorer, launcher.jobs


def read_history(out_dir: str, sig: str) -> tp.Optional[tp.List[dict]]:
    """The XP's history-torch.json, or None before its first epoch."""
    path = Path(out_dir) / "xps" / sig / HISTORY
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def is_done(out_dir: str, sig: str) -> bool:
    """The XP's run reached its end (done-torch.json is written only then,
    early stop included; history-torch.json exists after every epoch, so
    testing it would skip interrupted runs instead of resuming them)."""
    return (Path(out_dir) / "xps" / sig / DONE).exists()


def show_table(name: str, out_dir: str = "./outputs") -> None:
    explorer, jobs = get_grid(name)
    rows = []
    for job in jobs:
        sig = job.sig
        history = read_history(out_dir, sig)
        if history is not None:
            rows.append(explorer.table_row(sig, history))
        else:
            rows.append({"sig": sig, "epoch": "-", "train": "-",
                         "valid": "-", "best": "-"})
    if not rows:
        print("no jobs")
        return
    keys = list(rows[0].keys())
    widths = {k: max(len(k), *(len(str(r.get(k, "-"))) for r in rows))
              for k in keys}
    print("  ".join(k.rjust(widths[k]) for k in keys))
    for row in rows:
        print("  ".join(str(row.get(k, "-")).rjust(widths[k]) for k in keys))


def export_csv(name: str, out_dir: str = "./outputs",
               dest: tp.Optional[str] = None) -> Path:
    """Flat (sig, overrides..., metrics...) CSV for hyperparameter
    explorers like HiPlot."""
    import csv

    explorer, jobs = get_grid(name)
    rows = []
    for job in jobs:
        sig = job.sig
        row: tp.Dict[str, tp.Any] = {"sig": sig}
        row.update({k: repr(v) for k, v in job.overrides.items()})
        history = read_history(out_dir, sig)
        if history is not None:
            stages = explorer.process_history(history)
            for stage, metrics in stages.items():
                for key, val in metrics.items():
                    if isinstance(val, (int, float)):
                        row[f"{stage}.{key}"] = val
        rows.append(row)
    dest_path = Path(dest or (Path(out_dir) / f"grid_{name}.csv"))
    keys: tp.List[str] = []
    for row in rows:
        keys.extend(k for k in row if k not in keys)
    with open(dest_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {dest_path} ({len(rows)} rows)")
    return dest_path


def _job_command(job: Job, out_dir: str) -> tp.List[str]:
    """Subprocess command line training one grid job."""
    return [sys.executable, "-m", "brainmagick_tpu_torch.train",
            *job.to_tokens(), f"out_dir={out_dir!r}"]


def build_kernels(devices: tp.Iterable[str]) -> None:
    """Build the kernel library here, before subprocesses that run on a
    CUDA device start, so that each loads it instead of racing to run
    nvcc itself. Nothing to do when no device is CUDA or none is
    visible."""
    if torch.cuda.is_available() and any(
            torch.device(device).type == "cuda" for device in devices):
        from ..ops import _build
        _build.build()


def run_commands_with_logs(commands: tp.Sequence[tp.Tuple[str, tp.List[str]]],
                           log_dir: Path, workers: int
                           ) -> tp.Dict[str, int]:
    """Run (name, argv) subprocesses `workers` at a time, logging each
    to <log_dir>/<name>.log, with this process's data paths in their
    environment (``env.environ``); returns {name: returncode}. Shared by
    the grid runner and the eval fan-out. Negative returncodes (killed
    by signal) count as failures."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    environ = env.environ()

    def _one(item: tp.Tuple[str, tp.List[str]]) -> tp.Tuple[str, int]:
        name, argv = item
        log_path = log_dir / f"{name}.log"
        print(f"launching {name} -> {log_path}")
        with open(log_path, "w") as log:
            proc = subprocess.run(argv, stdout=log, stderr=subprocess.STDOUT,
                                  env=environ)
        status = "done" if proc.returncode == 0 else \
            f"FAILED rc={proc.returncode}"
        print(f"{status} {name}")
        return name, proc.returncode

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        results = dict(pool.map(_one, commands))
    failed = [name for name, rc in results.items() if rc != 0]
    if failed:
        logger.warning("%d/%d jobs failed: %s", len(failed),
                       len(results), ", ".join(failed))
    return results


def run_jobs(jobs: tp.Sequence[Job], out_dir: str = "./outputs",
             workers: int = 1, force: bool = False
             ) -> tp.Dict[str, tp.Optional[int]]:
    """Run grid jobs, `workers` at a time in subprocesses with per-job
    logs, or with one worker in this process, one after the other (the
    card's memory handed back between them). Returns {sig: returncode}:
    0 success, nonzero (negative = killed by signal) failure, None
    skipped as already trained (``is_done``)."""
    results: tp.Dict[str, tp.Optional[int]] = {}
    todo: tp.List[tp.Tuple[str, Job]] = []
    for job in jobs:
        sig = job.sig
        if not force and is_done(out_dir, sig):
            print(f"skipping {sig} (already trained; --force to rerun)")
            results[sig] = None
            continue
        todo.append((sig, job))

    if workers <= 1:
        from ..train import run
        for k, (sig, job) in enumerate(todo):
            print(f"[{k + 1}/{len(todo)}] running {sig} {job.overrides}")
            cfg = job.to_config()
            cfg.out_dir = out_dir
            run(cfg)
            results[sig] = 0
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        return results

    build_kernels(job.to_config().device for _, job in todo)
    commands = [(sig, _job_command(job, out_dir)) for sig, job in todo]
    results.update(run_commands_with_logs(commands, Path(out_dir) / "logs",
                                          workers))
    return results


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("available grids:", ", ".join(list_grids()))
        return
    name = argv[0]
    flags = set(argv[1:])
    workers = 1
    out_dir = "./outputs"
    for flag in flags:
        if flag.startswith("--workers="):
            workers = int(flag.split("=", 1)[1])
        elif flag.startswith("--out_dir="):
            out_dir = flag.split("=", 1)[1]
    explorer, jobs = get_grid(name)
    logger.info("Grid %s: %d jobs", name, len(jobs))
    if "--table" in flags:
        show_table(name, out_dir=out_dir)
        return
    if "--csv" in flags:
        export_csv(name, out_dir=out_dir)
        return
    if "--html" in flags:
        from .explore import export_html
        export_html(name, out_dir=out_dir)
        return
    if "--sbatch" in flags:
        from .slurm import export_sbatch
        kwargs: tp.Dict[str, tp.Any] = {}
        for flag in flags:
            for key in ("partition", "time", "cpus_per_task",
                        "gpus_per_task"):
                if flag.startswith(f"--{key}="):
                    val = flag.split("=", 1)[1]
                    kwargs[key] = (int(val) if key.endswith("_per_task")
                                   else val)
        export_sbatch(name, out_dir=out_dir, force="--force" in flags,
                      **kwargs)
        return
    if "--run" in flags:
        results = run_jobs(jobs, out_dir=out_dir, workers=workers,
                           force="--force" in flags)
        failed = {sig: rc for sig, rc in results.items() if rc}
        if failed:
            raise SystemExit(f"grid {name}: {len(failed)} of {len(results)} "
                             f"jobs failed: {failed}")
        return
    for job in jobs:
        print(job.sig, job.overrides)


if __name__ == "__main__":
    main()
