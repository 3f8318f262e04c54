"""A second synthetic study: 64-channel "EEG" at 250 Hz, two recordings.

Port of ``brainmagick_tpu/studies/fakeeeg.py``. Beside the fake MEG study
it drives training on studies of different sensor counts: the channels
padded to the largest count, each study's own layout, and the merger's
mask of the padded sensors.
"""

from __future__ import annotations

import typing as tp

import numpy as np

from ..events import EventTable
from . import api
from .fake import grid_positions, make_fake_events

RAW_SAMPLE_RATE = 250
N_CHANNELS = 64
N_TIMES = 25_000  # 100 s


class FakeeegRecording(api.Recording):

    data_url = "http://fake.invalid"
    paper_url = "http://fake.invalid"
    doi = ""
    licence = ""
    modality = ""
    language = ""
    device = "eeg"
    description = "Synthetic EEG study for multi-study tests."

    @classmethod
    def iter(cls, seed: int = 4321  # type: ignore[override]
             ) -> tp.Iterator["FakeeegRecording"]:
        for k in range(2):
            yield cls(str(k), seed=seed + k)

    def __init__(self, subject_uid: str, seed: int = 4321) -> None:
        super().__init__(subject_uid=subject_uid, recording_uid=subject_uid)
        self.seed = seed
        # keeps a fake study out of a real study's cache
        if self._cache_folder is not None \
                and "fake_cache" not in str(self._cache_folder):
            raise RuntimeError(
                "Fake recording cache path must contain 'fake_cache'")

    def _load_raw(self) -> api.RawData:
        rng = np.random.RandomState(self.seed)
        return api.RawData(
            data=rng.randn(N_CHANNELS, N_TIMES).astype(np.float32),
            sample_rate=float(RAW_SAMPLE_RATE),
            ch_names=[f"e{k}" for k in range(N_CHANNELS)],
            positions=grid_positions(N_CHANNELS))

    def _load_events(self) -> EventTable:
        return make_fake_events(total_duration=self.raw().duration,
                                seed=self.seed)
