"""``chip_smoke.py`` phase 15's planted-map rehearsal over training seeds,
on one device: whether its top-1 on the card lies where the CPU's does.

Run from the repository root (about 40 s a seed on an H100 after a
minute of set-up; about 10 minutes a seed on 6 CPU threads):

    python3 scripts/torch_rehearsal_card.py [device=cuda] \
        [seeds=2036,1,2,3] [dropout=device|cpu] [steps=N] [threads=6] \
        [workdir=DIR]

Writes phase 15's study with its own writers (4 KIT subjects, 48
sentences, the MEG a RandomState(777) mix of the port's seeded
Wav2VecTransformer track, rendered on ``device``, plus 0.3 x noise) into
``workdir`` (a new temporary directory, removed at the end, unless
given), then for each seed the rehearsal grid with phase 15's overrides
(``REHEARSAL_EXTRA``), ``seed`` and ``device``, trained in process and
evaluated by signature with ``REHEARSAL_NEGATIVES`` negatives. Prints
one line a seed, ``RESULT <device> seed <seed> top-1 <acc> over <n>
candidates, valid losses [...]``, and the device's name.

``dropout=cpu`` draws the merger's dropout disks from a CPU generator
seeded as the run's own (the port draws them on the run's device, whose
stream differs from the CPU's), so that a card run and a CPU run of one
seed see the same disks. ``steps=N`` also prints each seed's first N
train-step losses (``STEPS ...``), for finding where two runs part.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def render_track(root: Path, total: float, device: str) -> "np.ndarray":
    """The [1024, T@120 Hz] Wav2VecTransformer track of the study's first
    recording, rendered on `device` through the features' disk cache."""
    import chip_smoke as smoke
    from brainmagick_tpu_torch.features import FeaturesBuilder
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.studies.gwilliams2022 import (
        Gwilliams2022Recording)
    from brainmagick_tpu_torch.utils import Frequency

    with env.temporary(studies={smoke.KEPT_STUDY: root}):
        events = Gwilliams2022Recording(subject_uid="01", session="0",
                                        story="0")._load_events()
    builder = FeaturesBuilder(
        events, ["Wav2VecTransformer"], {"Wav2VecTransformer": dict(
            layers=smoke.W2V_LAYERS, device="cpu", random=True)},
        Frequency(120.), study=smoke.KEPT_STUDY, device=device)
    track, _, _ = builder(0.0, total)
    return track


def patch_solver(dropout_on_cpu: bool, steps: int, losses: list) -> None:
    """``dropout=cpu`` and ``steps=N`` on the port's Solver."""
    import torch

    from brainmagick_tpu_torch.solver import Solver

    if dropout_on_cpu:
        from_datasets = Solver.from_datasets.__func__

        def on_cpu(cls, *args, generator=None, **kwargs):
            if generator is not None:
                generator = torch.Generator().manual_seed(
                    generator.initial_seed())
            return from_datasets(cls, *args, generator=generator, **kwargs)

        Solver.from_datasets = classmethod(on_cpu)
    step = Solver.step

    def traced(self, arrays, pad_weight, train, **kwargs):
        metrics = step(self, arrays, pad_weight, train, **kwargs)
        if train and len(losses) < steps:
            losses.append(float(metrics["loss"]))
        return metrics

    Solver.step = traced


def run(device: str, seeds: list, workdir: Path, dropout_on_cpu: bool,
        steps: int) -> None:
    import numpy as np

    import chip_smoke as smoke
    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.grids import runner

    root, cache = workdir / "rehearsal", workdir / "cache_rehearsal"
    total = smoke.write_rehearsal_tree(root)
    with env.temporary(cache=cache):
        track = render_track(root, total, device)
    smoke.plant_rehearsal_meg(root, track, total)
    os.environ["BM_REHEARSAL_CACHE"] = str(cache)
    losses: list = []
    patch_solver(dropout_on_cpu, steps, losses)
    for seed in seeds:
        losses.clear()
        os.environ["BM_REHEARSAL_EXTRA"] = json.dumps(
            {**smoke.REHEARSAL_EXTRA, "seed": seed, "device": device})
        _, jobs = runner.get_grid(smoke.GRID)
        sig = jobs[0].sig
        out = workdir / f"{device}_seed{seed}"
        with env.temporary(cache=cache, studies={smoke.KEPT_STUDY: root}):
            results = runner.run_jobs(jobs, str(out), workers=1)
            if results != {sig: 0}:
                raise SystemExit(f"{device} seed {seed}: {results}")
            acc = port_eval.main([
                f"sig={sig}", f"out_dir={out}", f"device={device}",
                f"n_negatives={smoke.REHEARSAL_NEGATIVES}"])[1]
        n_cand = len(np.load(out / "eval" / f"{sig}-torch"
                             / "vocab_segment.npy"))
        history = json.loads((out / "xps" / sig / "history-torch.json"
                              ).read_text())
        valid = [round(h["valid"]["loss"], 4) for h in history]
        dropout = "cpu" if dropout_on_cpu else device
        if steps:
            print(f"STEPS {device} seed {seed} dropout {dropout}: "
                  f"{[round(x, 6) for x in losses]}", flush=True)
        print(f"RESULT {device} seed {seed} dropout {dropout} top-1 "
              f"{acc:.4f} over {n_cand} candidates, valid losses {valid}",
              flush=True)


def main(argv: list) -> None:
    import torch

    kw = dict(t.split("=", 1) for t in argv)
    device = kw.get("device", "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device=cuda needs a CUDA device; none is visible")
    torch.set_num_threads(int(kw.get("threads", 6)))
    seeds = [int(s) for s in kw.get("seeds", "2036,1,2,3").split(",")]
    sys.path.insert(0, str(ROOT))
    if device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, {device}", flush=True)
    options = dict(dropout_on_cpu=kw.get("dropout", "device") == "cpu",
                   steps=int(kw.get("steps", 0)))
    if "workdir" in kw:
        run(device, seeds, Path(kw["workdir"]), **options)
    else:
        with tempfile.TemporaryDirectory(prefix="bm_rehearsal_") as tmp:
            run(device, seeds, Path(tmp), **options)


if __name__ == "__main__":
    main(sys.argv[1:])
