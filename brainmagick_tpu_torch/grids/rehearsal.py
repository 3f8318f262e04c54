"""Dress-rehearsal grid: ONE job at the TRUE paper architecture.

A copy of ``brainmagick_tpu.grids.rehearsal``: the clip_conv_tpu preset
(depth 10, hidden 320, merger pos_dim 2048, kernel 3, dilation period 5,
GLU/2, complex_out) against wav2vec-dim-1024 targets
(``Wav2VecTransformer`` with random=True), shrunk ONLY in run length
(epochs / max_batches / batch size / negative counts), never in model or
feature shape, on a gwilliams2022 tree of four recordings.

Two environment hooks configure it without editing the grid, so the
subprocess jobs the runner spawns resolve the same XPs:
``BM_REHEARSAL_CACHE`` (the cache folder) and ``BM_REHEARSAL_EXTRA`` (a
JSON object of extra overrides, e.g. '{"dset.features": ["MelSpectrum"]}').
"""

import os

from .launcher import ClipExplorer


@ClipExplorer
def explorer(launcher):
    launcher.slurm_(chips=1, topology="v5e-1")
    launcher.bind_({"model": "clip_conv_tpu"})
    launcher.bind_({
        "dset.selections": ["gwilliams2022"],
        "dset.n_recordings": 4,
        "dset.min_n_blocks_per_split": 1,
        # 16 sentence blocks per recording, unmerged, so the sha-based
        # split assignment leaves no split empty at this small scale
        "dset.min_block_duration": 1.0,
        "dset.test_ratio": 0.3,
        "dset.valid_ratio": 0.2,
        "dset.features_params": {
            "Wav2VecTransformer": {
                "layers": [14, 15, 16, 17, 18], "device": "cpu",
                "random": True}},
        # run-length shrink only; the architecture stays paper-size
        "optim.epochs": 8,
        "optim.max_batches": 24,
        "optim.batch_size": 16,
        "optim.lr": 3e-4,
        "test.wer_negatives": 200,
        "test.wer_topx": 3,
        # the gate is the offline eval stage, so skip intermediate test
        # passes
        "eval_every": 8,
        "num_workers": 2,
    })
    cache = os.environ.get("BM_REHEARSAL_CACHE")
    if cache:
        launcher.bind_({"cache": cache})
    extra = os.environ.get("BM_REHEARSAL_EXTRA")
    if extra:
        import json
        launcher.bind_(json.loads(extra))
    launcher()
