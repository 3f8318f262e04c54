"""Recordings: lazy raw and events, cached preprocessing.

Port of ``brainmagick_tpu/studies/api.py``. A recording's raw is a
``RawData`` (fp32 [C, T], sample rate, channel names, 2D sensor
positions); ``preprocessed`` resamples it (and optionally highpasses it)
with the port's torch DSP on the given device and caches the result as a
memmap. The per-recording cache folder is the JAX package's
(``<cache>/studies/<study>/<uid>/``), but every file the port writes
there carries the backend tag (``cache.tagged``): the port reads no file
of the JAX package, and the JAX package none of the port's.
"""

from __future__ import annotations

import copy
import inspect
import json
import pickle
import threading
import typing as tp
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..cache import tagged
from ..env import env
from ..events import EventTable
from ..ops.dsp import DSP_VERSION, highpass_filter, resample
from ..utils import write_and_rename

#: position of a sensor whose position is unknown (a copy of
#: brainmagick_tpu.studies.api.INVALID_POSITION)
INVALID_POSITION = -0.1

register: tp.Dict[str, tp.Type["Recording"]] = {}
R = tp.TypeVar("R", bound="Recording")

#: preprocessing runs one recording at a time: datasets preload their
#: recordings in a thread pool
_PREPROCESS_LOCK = threading.Lock()


def from_selection(selection: tp.Dict[str, tp.Any]
                   ) -> tp.Iterator["Recording"]:
    """The recordings of a selection dict: its "study" names the study,
    the other keys go to ``Recording.iter``."""
    params = {k: v for k, v in selection.items() if v is not None}
    name = params.pop("study")
    return register[name].iter(**params)


def list_selections() -> tp.List[tp.Tuple[tp.Type["Recording"],
                                          tp.Dict[str, tp.Any]]]:
    """The named selections of ``MainConfig.selections`` but the fake
    studies', as (recording class, ``iter`` parameters) pairs."""
    from ..config import MainConfig

    out = []
    for params in MainConfig().selections.values():
        params = dict(params)
        study = params.pop("study")
        if not study.startswith("fake"):
            out.append((register[study], params))
    return out


@dataclass
class RawData:
    """Sensor time series of one recording."""
    data: np.ndarray                 # [C, T] float32
    sample_rate: float
    ch_names: tp.List[str]
    #: [C, 2] in [0, 1]^2, INVALID_POSITION where unknown
    positions: np.ndarray = field(default=None)
    #: each channel's kind code (FIFF's: 1 MEG, 2 EEG, 3 stim), or None
    #: when the file format gives none
    ch_kinds: tp.Optional[tp.List[int]] = None

    def __post_init__(self) -> None:
        assert self.data.ndim == 2
        if self.positions is None:
            self.positions = np.full((self.data.shape[0], 2),
                                     INVALID_POSITION, dtype=np.float32)
        assert self.positions.shape == (self.data.shape[0], 2)

    @property
    def n_channels(self) -> int:
        return self.data.shape[0]

    @property
    def n_times(self) -> int:
        return self.data.shape[1]

    @property
    def duration(self) -> float:
        return self.n_times / self.sample_rate


def preprocess_raw(raw: RawData, sample_rate: int, highpass: float = 0,
                   device: tp.Union[str, torch.device] = "cpu") -> RawData:
    """Resample to `sample_rate` and optionally highpass (by subtracting
    the lowpass), with ``ops.dsp`` on `device` in fp32; the result comes
    back to the host."""
    old_sr = int(round(raw.sample_rate))
    if sample_rate > old_sr:
        raise ValueError(f"The sample rate should be below {old_sr}Hz, "
                         f"got {sample_rate}")
    with _PREPROCESS_LOCK:
        data = torch.from_numpy(np.ascontiguousarray(
            raw.data, dtype=np.float32)).to(device)
        data = resample(data, old_sr, sample_rate)
        if highpass:
            data = highpass_filter(data, highpass / sample_rate)
        out = data.cpu().numpy()
    return RawData(data=out, sample_rate=float(sample_rate),
                   ch_names=list(raw.ch_names), positions=raw.positions)


class Recording:
    """One recording session of one subject.

    A study subclasses it (in a module of the study's name), implementing
    ``iter``, ``_load_events`` and ``_load_raw``."""

    data_url: str
    paper_url: str
    doi: str
    licence: str
    modality: str
    language: str
    device: str
    description: str

    @classmethod
    def iter(cls: tp.Type[R], **kwargs: tp.Any) -> tp.Iterator[R]:
        raise NotImplementedError

    def _load_events(self) -> EventTable:
        raise NotImplementedError

    def _load_raw(self) -> RawData:
        raise NotImplementedError

    @classmethod
    def study_name(cls) -> str:
        return cls.__name__.replace("Recording", "").lower()

    @classmethod
    def __init_subclass__(cls) -> None:
        super().__init_subclass__()
        if cls.__name__.startswith("_"):
            return
        name = cls.study_name()
        expected = cls.__module__.rsplit(".", maxsplit=1)[-1]
        assert name == expected, (
            f"Study {name} must be defined in a module named {name}, "
            f"found {expected}.")
        register[name] = cls
        for key in ("data_url", "paper_url", "doi", "licence", "modality",
                    "language", "device", "description"):
            assert isinstance(getattr(cls, key), str), \
                f"missing Recording.{key}"
        params = inspect.signature(cls.iter).parameters
        assert "study" not in params, '"study" is a reserved selection key.'

    def __init__(self, *, subject_uid: str, recording_uid: str) -> None:
        if not isinstance(subject_uid, str):
            raise TypeError(f"subject_uid must be a str, got: {subject_uid!r}")
        self.subject_uid = subject_uid
        self.recording_uid = recording_uid
        self._subject_index: tp.Optional[int] = None
        self._recording_index: tp.Optional[int] = None
        self._raw: tp.Optional[RawData] = None
        self._preprocessed: tp.Dict[tp.Tuple[int, float], RawData] = {}
        self._events: tp.Optional[EventTable] = None
        self._meta: tp.Optional[dict] = None
        if env.cache is None:
            self._cache_folder: tp.Optional[Path] = None
        else:
            self._cache_folder = (env.cache / "studies" / self.study_name()
                                  / recording_uid)
            self._cache_folder.mkdir(parents=True, exist_ok=True)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.recording_uid!r})"

    def _cache_file(self, name: str) -> tp.Optional[Path]:
        """This recording's cache file `name`, with the backend tag."""
        if self._cache_folder is None:
            return None
        return self._cache_folder / tagged(name)

    def empty_copy(self: R) -> R:
        """A copy without the loaded payloads."""
        out = copy.copy(self)
        out._events = None
        out._raw = None
        out._preprocessed = {}
        return out

    @property
    def subject_index(self) -> int:
        if self._subject_index is None:
            raise RuntimeError(
                "Recording.subject_index has not been initialized")
        return self._subject_index

    @property
    def recording_index(self) -> int:
        if self._recording_index is None:
            raise RuntimeError(
                "Recording.recording_index has not been initialized")
        return self._recording_index

    def _get_meta(self) -> dict:
        """Channel count, names and positions, cached so that no caller
        loads the raw only for its dimensions."""
        if self._meta is not None:
            return self._meta
        path = self._cache_file("meta.json")
        if path is not None and path.exists():
            with open(path) as f:
                self._meta = json.load(f)
            return self._meta
        raw = self.raw()
        self._meta = {
            "n_channels": raw.n_channels,
            "ch_names": list(raw.ch_names),
            "positions": np.asarray(raw.positions,
                                    dtype=np.float32).tolist(),
            "sample_rate": raw.sample_rate,
        }
        if path is not None:
            with write_and_rename(path, "w") as f:
                json.dump(self._meta, f)
        return self._meta

    @property
    def meg_dimension(self) -> int:
        return int(self._get_meta()["n_channels"])

    def raw(self) -> RawData:
        if self._raw is None:
            self._raw = self._load_raw()
        return self._raw

    def preprocessed(self, sample_rate: tp.Optional[float] = None,
                     highpass: float = 0,
                     device: tp.Union[str, torch.device] = "cpu"
                     ) -> RawData:
        """The recording at `sample_rate` Hz, computed on `device` once and
        cached as ``meg-sr{sr}-hp{hp}-dsp{DSP_VERSION}-torch.npy``."""
        if sample_rate is not None and sample_rate != int(sample_rate):
            raise ValueError("Only integer sampling rates are allowed")
        sample_rate = int(sample_rate) if sample_rate is not None else 0
        key = (sample_rate, highpass)
        if key in self._preprocessed:
            return self._preprocessed[key]
        if sample_rate == 0 and highpass == 0:
            return self.raw()
        filepath = self._cache_file(
            f"meg-sr{sample_rate}-hp{highpass}-dsp{DSP_VERSION}.npy")
        if filepath is not None and filepath.exists():
            meta = self._get_meta()
            out = RawData(
                data=np.lib.format.open_memmap(filepath, mode="r"),
                sample_rate=float(sample_rate), ch_names=meta["ch_names"],
                positions=np.asarray(meta["positions"], dtype=np.float32))
        else:
            raw = self.raw()
            if int(round(raw.sample_rate)) == sample_rate and highpass == 0:
                out = raw
            else:
                out = preprocess_raw(raw, sample_rate=sample_rate,
                                     highpass=highpass, device=device)
                if filepath is not None:
                    with write_and_rename(filepath) as f:
                        np.save(f, out.data)
        self._preprocessed[key] = out
        return out

    def events(self) -> EventTable:
        """The recording's typed events, parsed once and cached."""
        if self._events is None:
            path = self._cache_file("events.pkl")
            if path is not None and path.exists():
                with open(path, "rb") as f:
                    self._events = pickle.load(f)
            else:
                self._events = self._load_events()
                if path is not None:
                    with write_and_rename(path) as f:
                        pickle.dump(self._events, f)
        return self._events
