"""Paper Table 2: 3 seeds x 4 datasets x {clip_conv, random baseline,
MelSpectrum, MelSpectrum+DeepMel, MSE regression}
(reference: bm/grids/nmi/main_table.py:13-58)."""

from itertools import product

from ..launcher import ClipExplorer

SEEDS = (2036, 2037, 2038)
AUDIO_SETS = ("audio_mous", "gwilliams2022", "broderick2019", "brennan2019")


@ClipExplorer
def explorer(launcher):
    launcher.slurm_(chips=8, topology="v5e-8")
    launcher.bind_({"model": "clip_conv"})

    with launcher.job_array():
        for seed, dset in product(SEEDS, AUDIO_SETS):
            sub = launcher.bind({"dset.selections": [dset]}, seed=seed)
            if dset == "broderick2019":
                # faster in-training eval only; final eval uses all
                sub.bind_({"test.wer_recordings": 100})
            if dset == "audio_mous":
                # MOUS shows sentences in per-subject random order: split
                # on the sequence uid (no block merging)
                sub.bind_({"dset.force_uid_assignement": True})
            sub()  # the paper model
            # noise-level baseline
            sub({"optim.max_batches": 1, "optim.epochs": 1,
                 "test.wer_random": True})
            # speech-representation variations
            sub({"dset.features": ["MelSpectrum"]})
            sub({"dset.features": ["MelSpectrum"],
                 "feature_model": "deep_mel"})
            # plain regression
            sub({"optim.loss": "mse", "dset.features": ["MelSpectrum"]})
