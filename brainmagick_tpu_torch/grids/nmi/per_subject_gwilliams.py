"""Subject-count scaling on gwilliams2022
(reference: bm/grids/nmi/per_subject_gwilliams.py)."""

from ..launcher import ClipExplorer
from .main_table import SEEDS


@ClipExplorer
def explorer(launcher):
    launcher.slurm_(chips=8, topology="v5e-8")
    launcher.bind_({"model": "clip_conv", "optim.batch_size": 256})

    with launcher.job_array():
        for seed in SEEDS:
            sub = launcher.bind({"dset.selections": ["gwilliams2022"]},
                                seed=seed)
            sub.bind_({"dset.n_subjects_test": 3})
            for n_subj in range(3, 28, 3):
                sub({"dset.n_subjects": n_subj})
