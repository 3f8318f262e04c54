"""LR x batch-size sweep + meg-offset sweep + autoreject comparison
(reference: bm/grids/nmi/lr_batch_size.py)."""

from itertools import product

from ..launcher import ClipExplorer
from .main_table import SEEDS


@ClipExplorer
def explorer(launcher):
    launcher.slurm_(chips=8, topology="v5e-8")
    launcher.bind_({"model": "clip_conv"})

    lrs = (1e-4, 3e-4, 6e-4, 1e-3)
    batch_sizes = (32, 64, 128, 256)
    with launcher.job_array():
        for seed in SEEDS:
            sub = launcher.bind({"dset.selections": ["gwilliams2022"]},
                                seed=seed)
            for lr, batch_size in product(lrs, batch_sizes):
                sub({"optim.lr": lr, "optim.batch_size": batch_size})
            for offset in (0, 50, 100, 150, 200, 250, 300):
                sub({"task.offset_meg_ms": offset})
            # autoreject comparison on a small subset
            sub.bind_({"dset.n_recordings": 16})
            sub()
            sub({"dset.autoreject": True, "norm.max_scale": 1e12})
