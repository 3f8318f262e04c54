"""Phase 19 of chip_smoke.py alone, with what it reads: the kernels'
build, the gwilliams2022 tree of phase 9 (``write_gwilliams_tree``),
phase 11's feature-decoding XP (``train.main`` of ``WORDS_ARGS``) and
phase 12's encode_simpleconv XP (of ``ENCODE_RUNS``), then
``run_resume_phase`` (resuming a paper-width XP from the JAX package's
checkpoint.pkl, the notebook helpers, the native gather) and its kernels
against their plain versions at its shapes. Phase 9's epoch is not run,
so its seconds print as nan.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/torch_resume_phase.py

It needs about two minutes.
"""

import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from brainmagick_tpu_torch import train  # noqa: E402
from brainmagick_tpu_torch.env import env  # noqa: E402
from brainmagick_tpu_torch.ops import _build  # noqa: E402
from brainmagick_tpu_torch.precision import exact_fp32  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_resume_phase.py needs a CUDA device")
    device = torch.device("cuda", 0)
    card = cs.card()
    print(card, torch.__version__, torch.version.cuda, sys.version)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="resume_fake_cache_") as tmp:
        work = Path(tmp)
        cs.write_gwilliams_tree(work / cs.KEPT_STUDY,
                                np.random.RandomState(cs.SEED + 9))
        common = [f"cache={work}/cache_{cs.KEPT_STUDY}",
                  f"out_dir={work}/outputs"]
        for name, argv in (
                ("words", [*cs.WORDS_ARGS, *common, *cs.WORDS_FALLBACK]),
                ("encode_simpleconv", [*cs.ENCODE_RUNS["encode_simpleconv"],
                                       *cs.ENCODE_COMMON, *common])):
            t0 = time.perf_counter()
            with env.temporary(studies={cs.KEPT_STUDY:
                                        work / cs.KEPT_STUDY}):
                train.main(argv)
            print(f"{name} XP {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, shapes = cs.run_resume_phase(device, card, work,
                                               float("nan"))
        print(f"phase 19 {time.perf_counter() - t0:.1f} s; launches "
              f"{launches}")
    with exact_fp32():
        for path, shape in shapes.items():
            cs.check_cli_shapes(device, **shape, prefix=f"{path}: ")
    print("ok")


if __name__ == "__main__":
    main()
