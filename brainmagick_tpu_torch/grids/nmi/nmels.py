"""Number-of-mel-bands sweep (reference: bm/grids/nmi/nmels.py)."""

from itertools import product

from ..launcher import ClipExplorer
from .main_table import AUDIO_SETS, SEEDS


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
            for nmel in (20, 40, 80, 120):
                mel = sub.bind({"dset.features": ["MelSpectrum"]})
                mel.bind_({"dset.features_params.MelSpectrum.n_mels": nmel})
                mel()
                mel({"feature_model": "deep_mel"})
                mel({"optim.loss": "mse"})
