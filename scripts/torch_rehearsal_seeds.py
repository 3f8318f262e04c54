"""The planted-map rehearsal's top-1 over training seeds, in both
packages, on the CPU: how far its accuracy gate says that a run learns,
and how far it tells one package from the other.

Run from the repository root on a host with the JAX package and
``transformers`` (each run about 8 minutes on 3 CPU threads):

    python3 scripts/torch_rehearsal_seeds.py [workdir=DIR] \
        [seeds=2036,1,2,3] [packages=jax,torch] [workers=3] \
        [extra='{"simpleconv.fused_conv_bn": true}']

Writes the JAX package's rehearsal study (``scripts/rehearsal.py``:
4 KIT subjects, 48 sentences, the MEG a seeded mix of the seeded
Wav2VecTransformer track plus noise) into ``workdir``, a new directory
under the temporary directory unless given (a given ``workdir`` that
already holds the study is reused as it is), then for each
package and seed, in a process of its own (``workers`` at once): the
rehearsal grid (the paper's width, 8 epochs x 24 batches at B=16) with
``seed`` and ``extra`` as its extra overrides, trained in process on the
CPU and evaluated by signature with 200 negatives. Prints one line a
run, ``RESULT <package> seed <seed> top-1 <acc> over <n> candidates``.
The JAX package builds its literal xlsr-53 config: ``from_pretrained``
is replaced by one that raises OSError, so nothing is downloaded.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from concurrent import futures
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _offline() -> None:
    os.environ["HF_HUB_OFFLINE"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import transformers

    def refuse(*args, **kwargs):
        raise OSError("no checkpoint on disk")

    transformers.Wav2Vec2Config.from_pretrained = classmethod(refuse)
    transformers.Wav2Vec2Model.from_pretrained = classmethod(refuse)


def build(workdir: Path) -> None:
    """The JAX rehearsal's study under ``workdir/gwilliams``."""
    _offline()
    sys.path.insert(0, str(ROOT))
    from brainmagick_tpu.env import env
    from scripts.rehearsal import build_study

    root = workdir / "gwilliams"
    if (root / "download" / "participants.tsv").exists():
        return
    env.studies = {**env.studies, "gwilliams2022": root}
    with env.temporary(cache=workdir / "cache_jax"):
        build_study(root)


def run_one(package: str, seed: int, workdir: Path, extra: dict) -> None:
    """One rehearsal run of `package` with `seed`, printed as RESULT."""
    import numpy as np
    import torch

    torch.set_num_threads(3)
    sys.path.insert(0, str(ROOT))
    root = workdir / "gwilliams"
    out = workdir / f"{package}_seed{seed}"
    overrides = {"seed": seed, **extra}
    if package == "jax":
        _offline()
        from brainmagick_tpu.env import env
        from brainmagick_tpu.eval import run_eval
        from brainmagick_tpu.grids import runner
        from brainmagick_tpu.play import get_solver_from_sig
        cache = workdir / "cache_jax"
    else:
        from brainmagick_tpu_torch.env import env
        from brainmagick_tpu_torch.grids import runner
        cache = workdir / "cache_torch"
        overrides["device"] = "cpu"
    cache.mkdir(exist_ok=True)
    os.environ["BM_REHEARSAL_CACHE"] = str(cache)
    os.environ["BM_REHEARSAL_EXTRA"] = json.dumps(overrides)
    _, jobs = runner.get_grid("rehearsal")
    sig = jobs[0].sig
    with env.temporary(cache=cache, studies={"gwilliams2022": root}):
        results = runner.run_jobs(jobs, str(out), workers=1)
        if results.get(sig) not in (0, None):
            raise SystemExit(f"{package} seed {seed}: {results}")
        if package == "jax":
            solver = get_solver_from_sig(sig, out_dir=str(out),
                                         training=False)
            acc = float(run_eval(solver, out / "eval", n_negatives=200)
                        .loc[1, "acc_segment"])
            vocab = out / "eval" / "vocab_segment.npy"
        else:
            from brainmagick_tpu_torch import eval as port_eval
            acc = port_eval.main([f"sig={sig}", f"out_dir={out}",
                                  "n_negatives=200", "device=cpu"])[1]
            vocab = out / "eval" / f"{sig}-torch" / "vocab_segment.npy"
    print(f"RESULT {package} seed {seed} top-1 {acc:.4f} over "
          f"{len(np.load(vocab))} candidates", flush=True)


def main(argv: list) -> None:
    if argv[:1] == ["--one"]:
        package, seed, workdir, extra = argv[1:]
        run_one(package, int(seed), Path(workdir), json.loads(extra))
        return
    kw = dict(t.split("=", 1) for t in argv)
    if "workdir" in kw:
        workdir = Path(kw["workdir"])
        workdir.mkdir(parents=True, exist_ok=True)
    else:
        workdir = Path(tempfile.mkdtemp(prefix="bm_rehearsal_seeds_"))
    print(f"workdir {workdir}", flush=True)
    seeds = [int(s) for s in kw.get("seeds", "2036,1,2,3").split(",")]
    packages = kw.get("packages", "jax,torch").split(",")
    extra = kw.get("extra", "{}")
    subprocess.run([sys.executable, __file__, "--build", str(workdir)],
                   check=True)

    def one(package: str, seed: int) -> str:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", package, str(seed),
             str(workdir), extra], capture_output=True, text=True)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("RESULT")]
        return lines[-1] if lines and not proc.returncode else (
            f"FAILED {package} seed {seed}: {proc.stderr[-2000:]}")

    with futures.ThreadPoolExecutor(int(kw.get("workers", 3))) as pool:
        jobs = [pool.submit(one, p, s) for p in packages for s in seeds]
        for job in jobs:
            print(job.result(), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build(Path(sys.argv[2]))
    else:
        main(sys.argv[1:])
