"""Word-list training with shorter context (paper Table A.1;
reference: bm/grids/nmi/wordlists.py)."""

from ..launcher import ClipExplorer
from .main_table import SEEDS


@ClipExplorer
def explorer(launcher):
    launcher.slurm_(chips=8, topology="v5e-8")
    launcher.bind_({"model": "clip_conv", "optim.batch_size": 128,
                    "dset.force_uid_assignement": True})

    with launcher.job_array():
        for seed in SEEDS:
            sub = launcher.bind({"dset.selections": ["audio_mous_wl"]},
                                seed=seed)
            sub.bind_({"dset.tmin": -0.3, "dset.tmax": 0.5})
            sub()
