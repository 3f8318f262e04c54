"""Segment datasets: fixed windows of the recordings, their feature
tracks, and the host batch -> device tensors copy.

Port of ``brainmagick_tpu/dataset.py``, with the same segmentation (a
condition query or a fixed stride, tmin/tmax windows, baseline
correction, block containment, channel padding to the largest sensor
count) and the same ``get_datasets`` assembly (round-robin interleave of
the selections, subject and recording indices, deterministic block
splits, the n_subjects caps). Epochs are slices of each recording's
preprocessed memmap; the features are painted once per recording into a
[D + 1, T] track (the last row the event mask), cached as a memmap, and
sliced per epoch. ``get_batch`` assembles a whole batch with a numpy port
of the JAX package's fallback gather (``native/gather.py``).

``to_device`` copies a batch's arrays to a device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
import typing as tp
from collections import namedtuple
from concurrent import futures

import numpy as np
import torch

from . import studies
from .cache import Cache
from .events import DataSlice, EventTable, assign_blocks, split_wav_as_block
from .features import FeaturesBuilder
from .ops.dsp import DSP_VERSION
from .precision import torch_dtype
from .studies.api import INVALID_POSITION
from .utils import Frequency, as_tensor, roundrobin, transfer

logger = logging.getLogger(__name__)

#: cold track renders run one at a time (scaler-fit threads may reach
#: the tracks of several datasets at once)
_TRACK_RENDER_LOCK = threading.Lock()

Datasets = namedtuple("Datasets", "train valid test")

#: a copy of brainmagick_tpu.dataset.SegmentBatch.ARRAY_FIELDS
ARRAY_FIELDS = ("meg", "features", "features_mask", "subject_index",
                "recording_index", "positions")
_INDEX_FIELDS = ("subject_index", "recording_index")
#: the float payloads ``transfer_dtype`` casts
_WIRE_FIELDS = ("meg", "features")


def to_device(batch: tp.Any, device: tp.Union[str, torch.device],
              transfer_dtype: tp.Optional[str] = None,
              buffers: tp.Optional[tp.Dict[str, torch.Tensor]] = None
              ) -> tp.Dict[str, torch.Tensor]:
    """The batch's ``ARRAY_FIELDS`` (numpy, or tensors) on `device`:
    indices as int64, the rest in their own dtype, except that with
    `transfer_dtype` (``'bfloat16'``, ``parallel.transfer_dtype``) meg and
    features, when floating, are cast to it before they cross (on the host
    for a host array, halving the bytes of the transfer). Host arrays
    cross to a CUDA device as ``transfer`` says; arrays already on the
    device are not copied."""
    device = torch.device(device)
    wire = torch_dtype(transfer_dtype)
    out = {}
    for name in ARRAY_FIELDS:
        tensor = as_tensor(getattr(batch, name))
        dtype = tensor.dtype
        if name in _INDEX_FIELDS:
            dtype = torch.int64
        elif wire is not None and name in _WIRE_FIELDS \
                and tensor.is_floating_point():
            dtype = wire
        out[name] = transfer(tensor, device, dtype, buffers, name)
    return out


@dataclasses.dataclass
class SegmentBatch:
    """One segment ([C, T] meg, ...) or a batch of them ([B, C, T], ...),
    as numpy arrays or tensors, with the recordings and, when asked, each
    segment's events (the first marks the segment's start)."""

    meg: tp.Any                 # [B, C, T] or [C, T]
    features: tp.Any            # [B, F, T'] or [F, T']
    features_mask: tp.Any       # [B, 1, T'] or [1, T']
    subject_index: tp.Any       # [B] or scalar
    recording_index: tp.Any     # [B] or scalar
    positions: tp.Any           # [B, C, 2] or [C, 2]
    _recordings: tp.List[tp.Any] = dataclasses.field(default_factory=list)
    _event_lists: tp.List[tp.List[tp.Any]] = dataclasses.field(
        default_factory=list)

    ARRAY_FIELDS = ARRAY_FIELDS

    def replace(self, **kwargs: tp.Any) -> "SegmentBatch":
        return dataclasses.replace(self, **kwargs)

    def __len__(self) -> int:
        return len(self.meg)


class SegmentDataset:
    """Fixed windows over one recording: meg slices and feature-track
    slices. Made by ``SegmentDataset.Factory``."""

    def __init__(self, recording: studies.Recording, raw: studies.RawData,
                 sample_positions: np.ndarray, events: EventTable,
                 features: tp.Sequence[str],
                 features_params: tp.Optional[dict],
                 tmin: float, tmax: float,
                 baseline: tp.Optional[tp.Tuple[tp.Optional[float], float]],
                 event_mask: bool,
                 meg_dimension: tp.Optional[int],
                 device: tp.Union[str, torch.device] = "cpu") -> None:
        self.recording = recording
        self.raw = raw
        self.sample_rate = Frequency(raw.sample_rate)
        self.event_samples = sample_positions  # [N] int, event onsets
        self.events = events
        self.tmin = tmin
        self.tmax = tmax
        self.baseline = baseline
        self.meg_dimension = meg_dimension
        if meg_dimension is not None:
            assert meg_dimension >= raw.n_channels
        self.features_params = dict(features_params or {})
        self.features = FeaturesBuilder(
            events, features, features_params=self.features_params,
            sample_rate=self.sample_rate, event_mask=event_mask,
            study=recording.study_name(), device=device)
        self.blocks: tp.Optional[tp.List[tp.Tuple[float, float]]] = None
        self._start_offset = self.sample_rate.to_ind(tmin)
        self._n_times = self.sample_rate.to_ind(tmax - tmin) + 1
        self._track: tp.Optional[np.ndarray] = None  # [D+1, T]
        self._track_sr: tp.Optional[Frequency] = None
        self._records: tp.Optional[tuple] = None
        #: [N, meg_dimension, T] repaired epochs (dset.autoreject), which
        #: then take the place of the recording's
        self._meg_override: tp.Optional[np.ndarray] = None
        #: seconds spent painting or loading the feature track
        self.track_seconds = 0.

    def _get_track(self) -> tp.Tuple[np.ndarray, Frequency]:
        """The recording's feature track and its rate, painted (or read
        from the cache) on first use."""
        if self._track is None:
            with _TRACK_RENDER_LOCK:
                if self._track is None:
                    t0 = time.perf_counter()
                    self._render_track()
                    self.track_seconds += time.perf_counter() - t0
        return self._track, self._track_sr

    def _render_track(self) -> None:
        track_sr = self.features.render_sample_rate
        duration = self.raw.duration

        def compute() -> np.ndarray:
            data, mask = self.features.render_track(duration)
            return np.concatenate([data, mask.astype(np.float32)], axis=0)

        key = dict(
            dsp_version=DSP_VERSION,
            study=self.recording.study_name(),
            recording=self.recording.recording_uid,
            features=list(self.features.keys()),
            features_params=self.features_params,
            sample_rate=float(track_sr),
            event_mask=self.features.event_mask,
            events_fingerprint=_events_fingerprint(self.events))
        # a word feature's model or stand-in, as resolved on this host (no
        # key for the other features, whose entries keep their keys)
        backends = self.features.backends()
        if backends:
            key["backends"] = backends
        cache = Cache("feature_tracks", args=key, mode="memmap")
        self._track_sr = track_sr
        self._track = cache.get(compute)

    def __len__(self) -> int:
        return len(self.event_samples)

    def _bounds_times(self, idx: int) -> tp.Tuple[float, float]:
        start = int(self.event_samples[idx]) + self._start_offset
        stop = start + self._n_times
        return self.sample_rate.to_sec(start), self.sample_rate.to_sec(stop)

    def _get_meg(self, idx: int) -> np.ndarray:
        if self._meg_override is not None:
            return self._meg_override[idx]
        start = int(self.event_samples[idx]) + self._start_offset
        meg = np.array(self.raw.data[:, start:start + self._n_times],
                       dtype=np.float32)
        if self.baseline is not None:
            b0, b1 = self.baseline
            i0 = 0 if b0 is None else self.sample_rate.to_ind(b0 - self.tmin)
            i1 = self.sample_rate.to_ind(b1 - self.tmin) + 1
            meg = meg - meg[:, i0:i1].mean(axis=1, keepdims=True)
        if self.meg_dimension is not None:
            pad = self.meg_dimension - meg.shape[0]
            if pad:
                meg = np.pad(meg, ((0, pad), (0, 0)))
        return meg

    def _get_positions(self) -> np.ndarray:
        pos = self.raw.positions
        if self.meg_dimension is not None:
            pad = self.meg_dimension - pos.shape[0]
            if pad:
                pos = np.concatenate([
                    pos, np.full((pad, 2), INVALID_POSITION,
                                 dtype=np.float32)])
        return pos.astype(np.float32)

    def _event_records(self) -> tp.Tuple[np.ndarray, np.ndarray,
                                         tp.List[tp.Any]]:
        """The typed events with their start and stop arrays, built once
        per dataset."""
        if self._records is None:
            events = self.features.events
            self._records = (events["start"].astype(np.float64),
                             events["_stop"].astype(np.float64),
                             list(events.iter()))
        return self._records

    def _event_list(self, idx: int, track_sr: Frequency) -> tp.List[tp.Any]:
        """The events of window `idx`, after a DataSlice marking its
        bounds."""
        start, stop = self._bounds_times(idx)
        starts, stops, records = self._event_records()
        select = np.flatnonzero((stops >= start) & (starts < stop))
        marker = DataSlice(start=start, duration=stop - start,
                           sample_rate=float(track_sr), language=None,
                           modality=None)
        return [marker] + [records[k] for k in select]

    def _get_feature(self, idx: int) -> tp.Tuple[np.ndarray, np.ndarray,
                                                 tp.List[tp.Any]]:
        start, stop = self._bounds_times(idx)
        track, track_sr = self._get_track()
        i0 = track_sr.to_ind(start)
        n = track_sr.to_ind(stop - start)
        i0 = max(0, min(i0, track.shape[-1] - n))
        chunk = np.array(track[:, i0:i0 + n], dtype=np.float32)
        return chunk[:-1], chunk[-1:] > 0.5, self._event_list(idx, track_sr)

    def __getitem__(self, index: int) -> SegmentBatch:
        meg = self._get_meg(index)
        data, mask, event_list = self._get_feature(index)
        return SegmentBatch(
            meg=meg, features=data, features_mask=mask,
            subject_index=np.int32(self.recording.subject_index),
            recording_index=np.int32(self.recording.recording_index),
            positions=self._get_positions(),
            _recordings=[self.recording.empty_copy()],
            _event_lists=[event_list])

    def get_batch(self, indices: np.ndarray,
                  with_events: bool = False) -> SegmentBatch:
        """The windows `indices` as one fp32 batch, gathered from the
        recording and the track in one pass each."""
        indices = np.asarray(indices, dtype=np.int64)
        n = len(indices)
        starts = self.event_samples[indices] + self._start_offset
        if self._meg_override is not None:
            meg = np.asarray(self._meg_override[indices], dtype=np.float32)
        else:
            baseline_len = 0
            if self.baseline is not None:
                bl0, bl1 = self.baseline
                if bl0 is not None:
                    raise NotImplementedError(
                        "get_batch supports a (None, t1) baseline only")
                baseline_len = self.sample_rate.to_ind(bl1 - self.tmin) + 1
            meg = gather_epochs(self.raw.data, starts, self._n_times,
                                self.meg_dimension or self.raw.n_channels,
                                baseline_len)

        track, track_sr = self._get_track()
        if float(track_sr) == float(self.sample_rate):
            t_starts = starts
            n_track = self._n_times
        else:
            t_starts = np.array([
                track_sr.to_ind(self._bounds_times(int(i))[0])
                for i in indices], dtype=np.int64)
            n_track = track_sr.to_ind(self._n_times / float(self.sample_rate))
        t_starts = np.clip(t_starts, 0, track.shape[-1] - n_track)
        features = gather_track(track[:-1], t_starts, n_track)
        mask = gather_track(track[-1:], t_starts, n_track) > 0.5

        event_lists = [self._event_list(int(i), track_sr) for i in indices] \
            if with_events else []
        positions = self._get_positions()
        return SegmentBatch(
            meg=meg, features=features, features_mask=mask,
            subject_index=np.full(n, self.recording.subject_index,
                                  dtype=np.int32),
            recording_index=np.full(n, self.recording.recording_index,
                                    dtype=np.int32),
            positions=np.broadcast_to(positions, (n,) + positions.shape
                                      ).copy(),
            _recordings=[self.recording.empty_copy()] * n,
            _event_lists=event_lists)


def _check_bounds(starts: np.ndarray, n_times: int, total: int,
                  what: str) -> None:
    if len(starts) and (starts.min() < 0
                        or starts.max() + n_times > total):
        raise IndexError(f"{what} window outside the recording")


def gather_epochs(raw: np.ndarray, starts: np.ndarray, n_times: int,
                  out_channels: int, baseline_len: int = 0) -> np.ndarray:
    """[C, T_total] raw and [B] start samples -> [B, out_channels, n_times]
    fp32, each epoch less its mean over the first `baseline_len` samples,
    the channels past C zero (the JAX package's numpy gather)."""
    _check_bounds(starts, n_times, raw.shape[1], "epoch")
    out = np.zeros((len(starts), out_channels, n_times), dtype=np.float32)
    for b, s in enumerate(starts):
        epoch = np.array(raw[:, s:s + n_times], dtype=np.float32)
        if baseline_len > 0:
            epoch -= epoch[:, :baseline_len].mean(axis=1, keepdims=True)
        out[b, :raw.shape[0]] = epoch
    return out


def gather_track(track: np.ndarray, starts: np.ndarray,
                 n_times: int) -> np.ndarray:
    """[D, T_total] track and [B] starts -> [B, D, n_times] fp32."""
    _check_bounds(starts, n_times, track.shape[1], "track")
    return np.stack([np.array(track[:, s:s + n_times], dtype=np.float32)
                     for s in starts])


def _events_fingerprint(events: EventTable) -> str:
    """A content hash of the events, for the track cache's key."""
    h = hashlib.sha1()
    h.update(str(len(events)).encode())
    h.update(np.ascontiguousarray(
        events["start"].astype(np.float64)).tobytes())
    h.update(np.ascontiguousarray(
        events["duration"].astype(np.float64)).tobytes())
    if "offset" in events:
        h.update(np.nan_to_num(
            events["offset"].astype(np.float64)).tobytes())
    return h.hexdigest()[:16]


class _DatasetFactory:
    """How a recording is cut into windows."""

    def __init__(self,
                 condition: tp.Union[str, float] = 3.0,
                 tmin: float = -0.5,
                 tmax: float = 2.5,
                 baseline: tp.Any = (None, 0),
                 decim: int = 1,
                 sample_rate: float = 1200,
                 highpass: float = 0,
                 features: tp.Sequence[str] = ("WordLength", "WordFrequency"),
                 features_params: tp.Optional[dict] = None,
                 ignore_end_in_block: bool = False,
                 ignore_start_in_block: bool = False,
                 event_mask: bool = False,
                 split_wav_as_block: bool = False,
                 meg_dimension: tp.Optional[int] = None,
                 autoreject: bool = False,
                 device: tp.Union[str, torch.device] = "cpu") -> None:
        assert tmin < tmax
        assert decim == 1, "Decimation factor is not supported"
        self.autoreject = autoreject
        self.features = list(features)
        self.features_params = features_params
        self.condition = condition
        self.baseline = baseline
        self.sample_rate = int(round(sample_rate))
        self.highpass = highpass
        self.ignore_end_in_block = ignore_end_in_block
        self.ignore_start_in_block = ignore_start_in_block
        self.event_mask = event_mask
        self.meg_dimension = meg_dimension
        self.split_wav_as_block = split_wav_as_block
        self.tmin = tmin
        self.tmax = tmax
        #: where the features' models run (wav2vec 2.0)
        self.device = device

    def apply(self, recording: studies.Recording,
              blocks: tp.Optional[tp.List[tp.Tuple[float, float]]] = None
              ) -> tp.Optional[SegmentDataset]:
        if blocks is not None and not blocks:
            raise ValueError("No blocks provided.")
        raw = recording.preprocessed(self.sample_rate, highpass=self.highpass)
        sample_rate = Frequency(raw.sample_rate)
        assert int(sample_rate) == int(self.sample_rate)
        raw_end = (raw.n_times - 1) / sample_rate

        if isinstance(self.condition, str):
            query = (self.condition if "=" in self.condition
                     else f"kind=={self.condition!r}")
            times = recording.events().query(query)["start"].astype(
                np.float64)
        elif isinstance(self.condition, (int, float)):
            times = np.arange(0, raw_end, float(self.condition))
        else:
            raise TypeError(
                f"condition must be a query string or a stride in seconds, "
                f"got {self.condition!r}")

        events = recording.events().sort_by_start()
        if self.split_wav_as_block:
            assert blocks is not None
            events = split_wav_as_block(events, blocks)

        delta = 0.5 / sample_rate
        mask = np.logical_and(times + self.tmin >= 0,
                              times + self.tmax < raw_end + delta)
        if blocks is not None:
            in_any = np.zeros(len(times), dtype=bool)
            for start, stop in blocks:
                if self.ignore_start_in_block:
                    in_split = times >= start
                else:
                    in_split = times + self.tmin >= start
                margin = delta if self.ignore_end_in_block \
                    else self.tmax - delta
                in_split &= times + margin < stop
                in_any |= in_split
            mask &= in_any
        if not mask.any():
            logger.warning("Empty dataset %r", recording)
            return None

        samples = sample_rate.to_ind(times[mask])
        if len(np.unique(samples)) != len(samples):
            logger.warning("Found %d duplicate events out of %d",
                           len(samples) - len(np.unique(samples)),
                           len(samples))
        dset = SegmentDataset(
            recording, raw, sample_positions=samples, events=events,
            features=self.features, features_params=self.features_params,
            tmin=self.tmin, tmax=self.tmax, baseline=self.baseline,
            event_mask=self.event_mask, meg_dimension=self.meg_dimension,
            device=self.device)
        dset.blocks = blocks
        if self.autoreject:
            self._apply_autoreject(dset, raw)
        return dset

    def _apply_autoreject(self, dset: SegmentDataset,
                          raw: studies.RawData) -> None:
        """Fit the repair on 200 random epochs (cached), repair every
        epoch, and let the repaired epochs (padded to meg_dimension) take
        the place of the recording's in the batches."""
        from .autoreject import AutoRejectDrop

        cache = Cache("autoreject", args=(
            dict(recording=dset.recording.recording_uid,
                 sample_rate=self.sample_rate, tmin=self.tmin,
                 tmax=self.tmax, highpass=self.highpass),
            dset.blocks))
        epochs = np.stack([dset._get_meg(k)[:raw.n_channels]
                           for k in range(len(dset))])
        positions = raw.positions

        def _fit() -> AutoRejectDrop:
            logger.info("Fitting autoreject, cachefile %s",
                        cache.cache_path({}))
            rng = np.random.RandomState(1234)
            idx = rng.permutation(len(epochs))[:200]
            return AutoRejectDrop().fit(epochs[idx], positions)

        repaired = cache.get(_fit).transform(epochs, positions)
        if self.meg_dimension is not None:
            pad = self.meg_dimension - repaired.shape[1]
            if pad:
                repaired = np.pad(repaired, ((0, 0), (0, pad), (0, 0)))
        dset._meg_override = repaired


SegmentDataset.Factory = _DatasetFactory


class ConcatDataset:
    """Per-recording datasets end to end."""

    def __init__(self, datasets: tp.Sequence[tp.Any]) -> None:
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([0] + [len(d)
                                                 for d in self.datasets])

    def __len__(self) -> int:
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, index: int) -> SegmentBatch:
        if index < 0:
            index += len(self)
        d = int(np.searchsorted(self.cumulative_sizes, index,
                                side="right")) - 1
        return self.datasets[d][index - int(self.cumulative_sizes[d])]

    def get_batch(self, indices: np.ndarray,
                  with_events: bool = False) -> SegmentBatch:
        """The rows `indices`: each sub-dataset gathers its own, scattered
        into the batch's arrays in the order asked."""
        indices = np.asarray(indices, dtype=np.int64)
        which = np.searchsorted(self.cumulative_sizes, indices,
                                side="right") - 1
        parts: tp.List[tp.Tuple[np.ndarray, SegmentBatch]] = []
        for d in np.unique(which):
            sel = np.flatnonzero(which == d)
            local = indices[sel] - int(self.cumulative_sizes[d])
            parts.append((sel, self.datasets[int(d)].get_batch(
                local, with_events=with_events)))
        if len(parts) == 1:
            return parts[0][1]
        kw: tp.Dict[str, tp.Any] = {}
        for field in dataclasses.fields(SegmentBatch):
            first = getattr(parts[0][1], field.name)
            if field.name in ARRAY_FIELDS:
                out = np.empty((len(indices),) + first.shape[1:],
                               dtype=first.dtype)
                for sel, batch in parts:
                    out[sel] = getattr(batch, field.name)
                kw[field.name] = out
            elif any(getattr(b, field.name) for _, b in parts):
                items: tp.List[tp.Any] = [None] * len(indices)
                for sel, batch in parts:
                    for i, val in zip(sel.tolist(),
                                      getattr(batch, field.name)):
                        items[i] = val
                kw[field.name] = items
            else:
                kw[field.name] = []
        return SegmentBatch(**kw)


def _preload(recording: studies.Recording, **kwargs: tp.Any
             ) -> studies.Recording:
    """The recording's events and preprocessed raw, loaded (and cached)."""
    recording.events()
    recording.preprocessed(**kwargs)
    return recording


def _extract_recordings(selections: tp.List[tp.Dict[str, tp.Any]],
                        n_recordings: int, skip_recordings: int = 0,
                        shuffle_recordings_seed: int = -1
                        ) -> tp.Sequence[studies.Recording]:
    """The selections' recordings interleaved round-robin, with their
    subject and recording indices set."""
    recording_lists = [list(studies.from_selection(sel))
                       for sel in selections]
    if shuffle_recordings_seed > 0:
        rng = np.random.RandomState(seed=shuffle_recordings_seed)
        for lst in recording_lists:
            rng.shuffle(lst)
    all_recordings = list(roundrobin(*recording_lists))
    all_recordings = all_recordings[skip_recordings:
                                    skip_recordings + n_recordings]
    if len(all_recordings) < n_recordings:
        logger.warning("Requested %d recordings but only found %d",
                       n_recordings, len(all_recordings))
    uids = sorted({(r.__class__.__name__, r.subject_uid)
                   for r in all_recordings})
    uid_index = {uid: k for k, uid in enumerate(uids)}
    for r_index, rec in enumerate(all_recordings):
        index = uid_index[(rec.__class__.__name__, rec.subject_uid)]
        assert rec._subject_index in (None, index), \
            "Cannot assign a different index"
        rec._subject_index = index
        rec._recording_index = r_index
    return all_recordings


def _first_subjects(dsets: tp.List[SegmentDataset], n_subjects: int
                    ) -> int:
    """How many of `dsets`, from the first, hold `n_subjects` subjects."""
    seen: tp.Set[str] = set()
    count = 0
    for dset in dsets:
        seen.add(dset.recording.subject_uid)
        if len(seen) > n_subjects:
            break
        count += 1
    return count


def get_datasets(
        selections: tp.List[tp.Dict[str, tp.Any]],
        n_recordings: int,
        test_ratio: float,
        valid_ratio: float,
        sample_rate: int = 120,
        highpass: float = 0,
        num_workers: int = 10,
        apply_baseline: bool = True,
        progress: bool = False,
        skip_recordings: int = 0,
        min_block_duration: float = 0.0,
        force_uid_assignement: bool = True,
        shuffle_recordings_seed: int = -1,
        split_assign_seed: int = 12,
        min_n_blocks_per_split: int = 20,
        features: tp.Optional[tp.List[str]] = None,
        extra_test_features: tp.Optional[tp.List[str]] = None,
        test: tp.Optional[dict] = None,
        allow_empty_split: bool = False,
        n_subjects: tp.Optional[int] = None,
        n_subjects_test: tp.Optional[int] = None,
        remove_ratio: float = 0.,
        device: tp.Union[str, torch.device] = "cpu",
        **factory_kwargs: tp.Any) -> Datasets:
    """The train, valid and test splits of the selections' recordings, each
    a ConcatDataset of per-recording SegmentDatasets. The recordings are
    preprocessed on `device`, in a thread pool of `num_workers`, and the
    features' models (wav2vec 2.0) run there."""
    features = list(features or [])
    extra_test_features = list(extra_test_features or [])
    test = dict(test or {})

    num_workers = max(1, min(n_recordings, num_workers))
    all_recordings = _extract_recordings(
        selections, n_recordings, skip_recordings=skip_recordings,
        shuffle_recordings_seed=shuffle_recordings_seed)
    preload = dict(sample_rate=sample_rate, highpass=highpass, device=device)
    if num_workers <= 1 or len(all_recordings) <= 1:
        all_recordings = [_preload(r, **preload) for r in all_recordings]
    else:
        with futures.ThreadPoolExecutor(num_workers) as pool:
            jobs = [pool.submit(_preload, r, **preload)
                    for r in all_recordings]
            all_recordings = [j.result() for j in jobs]

    meg_dimension = max(r.meg_dimension for r in all_recordings)
    factory_kwargs.update(sample_rate=sample_rate, highpass=highpass,
                          meg_dimension=meg_dimension, device=device,
                          baseline=(None, 0) if apply_baseline else None)
    fact = SegmentDataset.Factory(features=features, **factory_kwargs)
    for key, value in test.items():
        if value is not None:
            factory_kwargs[key] = value
    fact_test = SegmentDataset.Factory(
        features=features + extra_test_features, **factory_kwargs)
    factories = [fact_test, fact, fact]  # split order: test, valid, train

    dsets_per_split: tp.List[tp.List[SegmentDataset]] = [[], [], []]
    for i, recording in enumerate(all_recordings):
        events = recording.events()
        blocks = events[events.kind_mask("block")]
        # schoffelen2019's blocks (one per sentence or sound) stay apart
        if min_block_duration > 0 and not force_uid_assignement \
                and recording.study_name() != "schoffelen2019":
            blocks = blocks.merge_blocks(
                min_block_duration_s=min_block_duration)
        blocks = assign_blocks(
            blocks, [test_ratio, valid_ratio], remove_ratio=remove_ratio,
            seed=split_assign_seed,
            min_n_blocks_per_split=min_n_blocks_per_split)
        for j, (factory, dsets) in enumerate(zip(factories,
                                                 dsets_per_split)):
            split_blocks = blocks[blocks["split"] == j]
            if split_blocks.empty:
                logger.warning("No blocks for split %d of recording %d",
                               j, i)
                continue
            start_stops = [(b["start"], b["start"] + b["duration"])
                           for b in split_blocks.records()]
            dset = factory.apply(recording, blocks=start_stops)
            if dset is not None:
                dsets.append(dset)
            else:
                logger.warning("Empty blocks for split %d of recording %d",
                               j, i)

    if not allow_empty_split:
        empty = [name for name, dsets in zip(
            ["train", "valid", "test"], dsets_per_split[::-1])
            if len(dsets) == 0]
        if empty:
            raise ValueError(f"The following splits are empty: {empty}.")

    testset, validset, trainset = dsets_per_split
    if n_subjects:
        count = _first_subjects(trainset, n_subjects)
        validset = validset[:count]
        trainset = trainset[:count]
    if n_subjects_test:
        testset = testset[:_first_subjects(testset, n_subjects_test)]

    splits = [ConcatDataset(d) for d in (trainset, validset, testset)]
    logger.info("# Examples (train | valid | test): %s",
                " | ".join(str(len(s)) for s in splits))
    return Datasets(*splits)
