"""SLURM array-job emitter for grids.

Port of ``brainmagick_tpu/grids/slurm.py``: a self-contained ``sbatch``
array script with one task per PENDING job (no done-torch.json, the
runner's rule), per-task logs, and the exact ``python -m
brainmagick_tpu_torch.train`` command lines the local runner would
execute. Nothing here imports SLURM: the script is inspectable text,
submitted with ``sbatch``.

CLI:
    python -m brainmagick_tpu_torch.grids <grid> --sbatch \
        [--out_dir=...] [--partition=gpu] [--time=24:00:00] \
        [--gpus_per_task=0] [--cpus_per_task=8]
"""

from __future__ import annotations

import shlex
import typing as tp
from pathlib import Path

_HEADER = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --array=0-{last}
#SBATCH --output={logs}/%x_%a.log
#SBATCH --time={time}
#SBATCH --cpus-per-task={cpus}
{extra}
set -euo pipefail
cd {workdir}
case "$SLURM_ARRAY_TASK_ID" in
"""

_FOOTER = """*) echo "no task $SLURM_ARRAY_TASK_ID"; exit 1 ;;
esac
"""


def export_sbatch(name: str, out_dir: str = "./outputs",
                  dest: tp.Optional[str] = None, partition: str = "",
                  time: str = "24:00:00", cpus_per_task: int = 8,
                  gpus_per_task: int = 0,
                  force: bool = False, workdir: tp.Optional[str] = None
                  ) -> Path:
    """Write an array script covering the grid's pending jobs."""
    from .runner import _job_command, get_grid, is_done

    _, jobs = get_grid(name)
    out = Path(out_dir)
    pending = [job for job in jobs if force or not is_done(out_dir, job.sig)]
    if not pending:
        raise SystemExit(f"grid {name}: all {len(jobs)} jobs already "
                         "trained (--force to rerun)")
    # absolute: slurmd resolves --output against the SUBMISSION cwd,
    # which need not be the cwd this script was emitted from
    logs = (out / "logs").resolve()
    logs.mkdir(parents=True, exist_ok=True)
    extra_lines = []
    if partition:
        extra_lines.append(f"#SBATCH --partition={partition}")
    if gpus_per_task:
        extra_lines.append(f"#SBATCH --gpus-per-task={gpus_per_task}")
    body = _HEADER.format(
        name=f"bm_{name.replace('.', '_')}", last=len(pending) - 1,
        logs=shlex.quote(str(logs)), time=time, cpus=cpus_per_task,
        extra="\n".join(extra_lines),
        workdir=shlex.quote(str(Path(workdir or ".").resolve())))
    for k, job in enumerate(pending):
        cmd = " ".join(shlex.quote(c) for c in _job_command(job, out_dir))
        body += f"{k}) {cmd} ;;\n"
    body += _FOOTER
    dest_path = Path(dest or (out / f"grid_{name}.sbatch"))
    dest_path.parent.mkdir(parents=True, exist_ok=True)
    dest_path.write_text(body)
    dest_path.chmod(0o755)
    print(f"wrote {dest_path}: {len(pending)} pending of {len(jobs)} "
          f"jobs (submit: sbatch {dest_path})")
    return dest_path
