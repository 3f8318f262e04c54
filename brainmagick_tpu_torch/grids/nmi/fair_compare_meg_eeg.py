"""Channel- and data-matched MEG vs EEG comparison
(reference: bm/grids/nmi/fair_compare_meg_eeg.py)."""

from itertools import product

from ..launcher import ClipExplorer
from .main_table import SEEDS

AUDIO_SETS = ("audio_mous", "gwilliams2022", "broderick2019")


@ClipExplorer
def explorer(launcher):
    launcher.slurm_(chips=8, topology="v5e-8")
    launcher.bind_({"model": "clip_conv"})

    with launcher.job_array():
        for seed, dset in product(SEEDS, AUDIO_SETS):
            sub = launcher.bind({"dset.selections": [dset]}, seed=seed)
            if dset == "broderick2019":
                sub.bind_({"test.wer_recordings": 100})
            if dset == "audio_mous":
                sub.bind_({"dset.force_uid_assignement": True})
                # match Broderick: 19 subjects, 128 channels, trimmed data
                sub.bind_({"dset.n_recordings": 19,
                           "simpleconv.subsample_meg_channels": 128,
                           "dset.remove_ratio": 0.})
            elif dset == "gwilliams2022":
                sub.bind_({"dset.n_recordings": 140,
                           "simpleconv.subsample_meg_channels": 128})
            sub()
