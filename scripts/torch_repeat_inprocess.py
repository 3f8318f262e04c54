"""Where the launcher's loss gap comes from: the one-card training run of
``chip_smoke.py`` phase 14, repeated in fresh processes.

Run from the repository root on a CUDA card (about three minutes):

    python3 scripts/torch_repeat_inprocess.py

Writes phase 9's gwilliams2022 tree into a temporary folder (its name
holds ``fake_cache``), builds the kernels, then runs the train CLI with
phase 14's overrides (``chip_smoke.PARALLEL_ARGS``, PARALLEL_BATCHES
batches, a valid and a test stage) in fresh processes, each into its own
``out_dir`` over one shared cache: a first run that fills the cache (not
compared), two runs without the launcher (``python -m
brainmagick_tpu_torch.train``), and one under ``python -m
torch.distributed.run --standalone --nproc_per_node=1``. Prints each run's
history and, for each pair, every loss's relative difference and every
test metric's absolute one. If the two runs without the launcher differ
as much as the launcher's run differs from them, the gap comes from
choices each process makes (cuBLAS and cuDNN algorithms, the order of
float sums), not from the launcher.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _run(argv: list, environ: dict, launcher: bool) -> float:
    head = [sys.executable, "-m"]
    if launcher:
        head += ["torch.distributed.run", "--standalone",
                 "--nproc_per_node=1", "-m"]
    t0 = time.perf_counter()
    proc = subprocess.run([*head, "brainmagick_tpu_torch.train", *argv],
                          cwd=ROOT, env=environ, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        print((proc.stdout + proc.stderr)[-6000:])
        raise SystemExit(f"{argv[-1]} exited {proc.returncode}")
    return time.perf_counter() - t0


def _diffs(a: dict, b: dict) -> dict:
    out = {}
    for stage, metrics in a.items():
        for key, value in metrics.items():
            got = b[stage][key]
            out[f"{stage} {key}"] = abs(got - value) / abs(value) \
                if stage != "test" else abs(got - value)
    return out


def main() -> None:
    import torch

    from brainmagick_tpu_torch.env import env
    from brainmagick_tpu_torch.ops import _build
    from brainmagick_tpu_torch.train import parse_overrides

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = cs.card()
    print(card)
    _build.build()
    with tempfile.TemporaryDirectory(prefix="repeat_fake_cache_") as tmp:
        work = Path(tmp)
        cs.write_gwilliams_tree(work / cs.KEPT_STUDY,
                                np.random.RandomState(0))
        common = [*cs.PARALLEL_ARGS,
                  f"optim.max_batches={cs.PARALLEL_BATCHES}",
                  f"cache={work}/cache"]
        with env.temporary(studies={cs.KEPT_STUDY: work / cs.KEPT_STUDY}):
            environ = dict(env.environ(), PYTHONPATH=str(ROOT),
                           OMP_NUM_THREADS="4")
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            environ.pop(key, None)
        runs = {"warm-up": False, "plain A": False, "plain B": False,
                "launcher": True}
        histories = {}
        for name, launcher in runs.items():
            argv = common + [f"out_dir={work}/{name.replace(' ', '_')}"]
            seconds = _run(argv, environ, launcher)
            folder = Path(parse_overrides(argv).xp_folder)
            histories[name] = cs._read_history(folder, 1, name)[0]
            print(f"{name} ({card}): {seconds:.1f} s, history "
                  f"{json.dumps(histories[name])}")
        del histories["warm-up"]
        for a, b in itertools.combinations(histories, 2):
            diffs = _diffs(histories[a], histories[b])
            print(f"{a} against {b} ({card}): largest "
                  f"{max(diffs.values()):.3e}; {diffs}")


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    main()
