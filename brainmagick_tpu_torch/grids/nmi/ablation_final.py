"""Paper Table 4 ablations: toggle merger / glu / initial_linear / gelu /
skip / complex_out / subject_layers / clamp
(reference: bm/grids/nmi/ablation_final.py:13-52)."""

from itertools import product

from ..launcher import ClipExplorer
from .main_table import AUDIO_SETS, SEEDS


@ClipExplorer
def explorer(launcher):
    launcher.slurm_(chips=8, topology="v5e-8")
    launcher.bind_({"model": "clip_conv", "optim.batch_size": 256})

    with launcher.job_array():
        for seed, dset in product(SEEDS, AUDIO_SETS):
            sub = launcher.bind({"dset.selections": [dset]}, seed=seed)
            if dset == "broderick2019":
                sub.bind_({"test.wer_recordings": 100})
            if dset == "audio_mous":
                sub.bind_({"dset.force_uid_assignement": True})
            sub()  # reference model
            sub({"simpleconv.merger": False})
            sub({"simpleconv.merger_dropout": 0.})
            sub({"simpleconv.glu": 0})
            sub({"simpleconv.initial_linear": 0})
            sub({"simpleconv.gelu": False})
            sub({"simpleconv.skip": False})
            sub({"simpleconv.complex_out": False})
            sub({"simpleconv.subject_layers": False})
            sub({"simpleconv.subject_layers": False,
                 "simpleconv.subject_dim": 64})
            sub({"norm.max_scale": 100})
            sub({"norm.max_scale": 1e12})
