"""Phase 20 of chip_smoke.py alone, with what it reads: the kernels'
build, the gwilliams2022 tree of phase 9 (``write_gwilliams_tree``),
then ``run_hosts_phase`` (two hosts of two ranks spawned on the one card
against one host of four, each host's test stage against its rows scored
in one process, and the event query) and its kernels against their plain
versions at a rank's shapes.

Run on a machine with a CUDA card, from the repository root:

    python3 scripts/torch_hosts_phase.py

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
from brainmagick_tpu_torch.ops import _build  # noqa: E402
from brainmagick_tpu_torch.precision import exact_fp32  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_hosts_phase.py needs a CUDA device")
    device = torch.device("cuda", 0)
    card = cs.card()
    print(card, torch.__version__, torch.version.cuda, sys.version)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="hosts_fake_cache_") as tmp:
        work = Path(tmp)
        cs.write_gwilliams_tree(work / cs.KEPT_STUDY,
                                np.random.RandomState(cs.SEED + 9))
        t0 = time.perf_counter()
        launches, shapes = cs.run_hosts_phase(device, card, work)
        print(f"phase 20 {time.perf_counter() - t0:.1f} s; launches "
              f"{launches}")
    with exact_fp32():
        for path, shape in shapes.items():
            cs.check_cli_shapes(device, **shape, prefix=f"{path}: ")
    print("ok")


if __name__ == "__main__":
    main()
