"""The synthetic study: noise MEG and scripted events over a mock wav.

Port of ``brainmagick_tpu/studies/fake.py``: 4 recordings of 273-channel
MEG at 1200 Hz (99,999 samples), with word, phoneme, sound and block
events, from the same seeds and with the same values.
"""

from __future__ import annotations

import itertools
import random
import typing as tp

import numpy as np

from .. import mockdata
from ..events import EventTable
from ..phonemes import ph_dict
from . import api

RAW_SAMPLE_RATE = 1200
N_CHANNELS = 273
N_TIMES = 99_999


def grid_positions(n_channels: int) -> np.ndarray:
    """A synthetic sensor layout: points on a disk (sunflower pattern)."""
    k = np.arange(n_channels)
    golden = (1 + 5 ** 0.5) / 2
    r = np.sqrt((k + 0.5) / n_channels)
    theta = 2 * np.pi * k / golden ** 2
    x = 0.5 + 0.5 * r * np.cos(theta)
    y = 0.5 + 0.5 * r * np.sin(theta)
    return np.stack([x, y], axis=1).astype(np.float32)


def create_fake_meg(seed: int = 1234) -> api.RawData:
    """Random-noise [273, 99999] recording at 1200 Hz."""
    rng = np.random.RandomState(seed)
    data = rng.randn(N_CHANNELS, N_TIMES).astype(np.float32)
    ch_names = [f"c{k}" for k in range(N_CHANNELS)]
    return api.RawData(data=data, sample_rate=float(RAW_SAMPLE_RATE),
                       ch_names=ch_names,
                       positions=grid_positions(N_CHANNELS))


def make_fake_events(total_duration: float = 83,
                     seed: int = 1234) -> EventTable:
    """Scripted word, phoneme, sound and block events."""
    rng = random.Random(seed)
    event_dicts: tp.List[dict] = []
    wavpath = mockdata.mock_wav_path()
    word_sequence = ["Toen", "barkeeper", "de"]
    language = "nl"

    time = 0.0
    duration = 0.0
    for block_index in itertools.count():
        time += rng.uniform(0.5, 1.0)
        block_start = time
        n_repeats = rng.randint(2, 3)
        sequence = word_sequence * n_repeats
        for word_index, word in enumerate(sequence):
            duration = rng.uniform(0.1, 0.2)
            time += duration + rng.uniform(0.1, 0.3)
            modality = rng.choice(["audio", "visual"])
            event_dicts.append(dict(
                kind="word", start=time, duration=duration, modality=modality,
                language=language, word=word, word_index=word_index,
                word_sequence=" ".join(sequence), condition="sentence"))
            if modality == "audio":
                ph_id = rng.choice(list(ph_dict.values()))
                event_dicts.append(dict(
                    kind="phoneme", start=time, duration=duration,
                    phoneme_id=ph_id, modality=modality, language=language))
        block_end = time + duration
        event_dicts.append(dict(kind="sound", start=block_start,
                                duration=block_end - block_start,
                                filepath=str(wavpath)))
        event_dicts.append(dict(kind="block", start=block_start,
                                duration=block_end - block_start,
                                uid="block" + str(block_index)))
        if time > total_duration:
            break
    return EventTable.from_records(event_dicts).validate()


class FakeRecording(api.Recording):

    data_url = "http://fake.invalid"
    paper_url = "http://fake.invalid"
    doi = ""
    licence = ""
    modality = ""
    language = ""
    device = "meg"
    description = "Fake recording used for testing."

    @classmethod
    def iter(cls, seed: int = 1234  # type: ignore[override]
             ) -> tp.Iterator["FakeRecording"]:
        for k in range(4):
            yield cls(str(k), seed=seed + k)

    def __init__(self, subject_uid: str, seed: int = 1234) -> None:
        super().__init__(subject_uid=subject_uid, recording_uid=subject_uid)
        self.seed = seed
        # keeps a fake study out of a real study's cache
        if self._cache_folder is not None \
                and "fake_cache" not in str(self._cache_folder):
            raise RuntimeError(
                "Fake recording cache path must contain 'fake_cache'")

    def _load_events(self) -> EventTable:
        return make_fake_events(total_duration=self.raw().duration,
                                seed=self.seed)

    def _load_raw(self) -> api.RawData:
        return create_fake_meg(seed=self.seed)
