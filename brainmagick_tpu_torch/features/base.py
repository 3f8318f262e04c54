"""FeaturesBuilder: named features rendered into a dense [D, T] array for
any [start, stop) window of a recording.

Port of ``brainmagick_tpu/features/base.py``, on an ``events.EventTable``:

  * the channels are each feature's ``dimension`` rows in order;
    ``get_slice(name)`` gives a feature's rows, and
    ``get_slice(name, model_output=True)`` its rows in the model's output,
    where a categorical feature takes ``cardinality`` logits;
  * ``__call__(start, stop)`` -> (data [D, T] float32, mask [1, T] bool,
    events): each feature's default value, then the events overlapping
    the window painted at the sample positions of the recording's
    timeline; ``event_mask=True`` paints the word-occupancy mask;
  * ``render_track`` paints a whole recording once (the datasets cache it
    as a memmap and slice it per segment);
  * a feature with a model (wav2vec 2.0) runs it on the builder's
    ``device`` (``Feature.place``), the run's device in the datasets;
  * a feature with an ``allow_fallback`` of None (the word embeddings and
    the part of speech) may use its offline stand-in only on a synthetic
    study (``_FALLBACK_STUDIES``) or outside any study; an explicit
    ``features_params.<name>.allow_fallback`` wins.

Painting runs on the host, in numpy, as in the JAX package.
"""

from __future__ import annotations

import logging
import typing as tp
from collections import OrderedDict

import numpy as np

from ..events import DataSlice, Event, EventTable
from ..utils import Frequency

logger = logging.getLogger(__name__)


class Feature:
    """Base feature: maps one event kind to channel values; subclasses
    register under their class name."""

    event_kind = ""
    dimension = 1
    cardinality: tp.Optional[int] = None  # set -> categorical feature
    default_value: float = 0.
    sample_rate = Frequency(float("nan"))

    @classmethod
    def __init_subclass__(cls) -> None:
        super().__init_subclass__()
        assert cls.event_kind, "Missing event_kind"
        if cls.__name__.startswith("_"):
            return
        FeaturesBuilder._FEATURE_CLASSES[cls.__name__] = cls

    def __init__(self, sample_rate: Frequency, **kwargs: tp.Any) -> None:
        self.sample_rate = sample_rate
        self._params = dict(kwargs)
        assert self.dimension >= 1
        assert self.cardinality is None or self.dimension == 1, \
            "categorical features must be single-channel"

    @property
    def name(self) -> str:
        return self.__class__.__name__

    @property
    def output_dimension(self) -> int:
        """Channels in the model's output (``cardinality`` logits for a
        categorical feature)."""
        return self.dimension if self.cardinality is None else self.cardinality

    @property
    def categorical(self) -> bool:
        return self.cardinality is not None

    @property
    def normalizable(self) -> bool:
        return not self.categorical

    def __repr__(self) -> str:
        return f"{self.name}({float(self.sample_rate)})"

    def get(self, event: tp.Any) -> tp.Union[float, int, np.ndarray]:
        """Value(s) for the whole event."""
        raise NotImplementedError

    def get_on_overlap(self, event: Event, overlap: DataSlice
                       ) -> tp.Union[float, int, np.ndarray]:
        """Value(s) on the part of the event inside the window: [D, L]
        values of ``get`` are cut to the overlap (one sample of replicate
        padding absorbs a rounding difference)."""
        val = self.get(event)
        if isinstance(val, np.ndarray):
            if val.ndim == 2:
                assert val.shape[-1] > 0
                first = max(0, -overlap._sample_rate.to_ind(
                    event.start - overlap.start))
                first = min(first, val.shape[-1] - 1)
                val = val[:, first: first + overlap.duration_ind]
                if overlap.duration_ind - val.shape[-1] == 1:
                    val = np.concatenate([val, val[:, -1:]], axis=-1)
                else:
                    assert val.shape[-1] == overlap.duration_ind, \
                        (val.shape, overlap.duration_ind)
            while val.ndim < 2:
                val = val[..., None]
            if val.ndim > 2:
                raise RuntimeError(f"Unexpected shape {val.shape}")
        elif not isinstance(val, (int, float, np.integer, np.floating)):
            raise TypeError(f"Invalid type {type(val)} for feature {self}")
        return val

    def post_process(self, block: np.ndarray) -> None:
        """In-place transform of the painted rows."""

    def place(self, device: tp.Any) -> None:
        """Where the feature's model runs (a feature without one paints
        on the host and ignores it)."""


class FeaturesBuilder(OrderedDict):
    """Ordered mapping name -> Feature, with the painter."""

    _FEATURE_CLASSES: tp.Dict[str, tp.Type[Feature]] = {}

    #: studies whose features may fall back to their offline stand-ins
    #: (hash embeddings, the rule-based tagger) when a model is not on disk
    _FALLBACK_STUDIES = ("fake", "fakeeeg")

    def __init__(self, events: EventTable, features: tp.Sequence[str],
                 features_params: tp.Optional[dict],
                 sample_rate: Frequency, event_mask: bool = False,
                 study: tp.Optional[str] = None,
                 device: tp.Any = None) -> None:
        super().__init__()
        features = list(features)
        self.features_params = dict(features_params or {})
        self.sample_rate = sample_rate
        self.event_mask = event_mask
        missing = set(features) - set(self._FEATURE_CLASSES)
        if missing:
            options = ", ".join(sorted(set(self._FEATURE_CLASSES)
                                       - set(features)))
            raise KeyError(f"Could not find feature(s): "
                           f"{', '.join(sorted(missing))}. "
                           f"Available: {options}")
        self.update([
            (name, self._FEATURE_CLASSES[name](
                sample_rate=self.sample_rate,
                **self.features_params.get(name, {})))
            for name in features])
        # a real study with a missing model fails loudly rather than train
        # on stand-ins; study None is direct library use
        auto_allowed = study is None or study in self._FALLBACK_STUDIES
        for feature in self.values():
            if getattr(feature, "allow_fallback", False) is None:
                feature.allow_fallback = auto_allowed
            if device is not None:
                feature.place(device)

        event_kinds = {f.event_kind for f in self.values()}
        if self.event_mask:
            from .basic import WordSegment
            self.word_seg_feature = WordSegment(self.sample_rate)
            event_kinds.add(self.word_seg_feature.event_kind)

        self.events = events[events.kind_mask(*event_kinds)]
        self.events = self.events.assign(
            _stop=self.events["start"] + self.events["duration"])
        missing_kinds = event_kinds - set(events["kind"].tolist()) \
            - {"sound"}
        if missing_kinds and len(events) > 0:
            logger.warning("No events found for feature kind(s): %s",
                           missing_kinds)

    @property
    def dimension(self) -> int:
        return sum(f.dimension for f in self.values())

    @property
    def output_dimension(self) -> int:
        return sum(f.output_dimension for f in self.values())

    def get_slice(self, name: str, model_output: bool = False) -> slice:
        if name not in self:
            raise KeyError(f"Could not find feature {name}.")
        start = 0
        for key, feature in self.items():
            dim = feature.output_dimension if model_output \
                else feature.dimension
            if name == key:
                return slice(start, start + dim)
            start += dim
        raise AssertionError  # unreachable

    def extract_features(self, features: np.ndarray,
                         feature_names: tp.Sequence[str]) -> np.ndarray:
        """The [*, D, T] rows of the named features, in that order."""
        assert features.shape[1] == self.dimension, \
            "Input should contain all features"
        assert all(name in self for name in feature_names)
        chunks = [features[:, self.get_slice(name)]
                  for name in feature_names]
        return np.concatenate(chunks, axis=1)

    @property
    def render_sample_rate(self) -> Frequency:
        """A single feature's own sample rate, else the builder's."""
        if len(self) == 1:
            return next(iter(self.values())).sample_rate
        return self.sample_rate

    def __call__(self, start: float, stop: float
                 ) -> tp.Tuple[np.ndarray, np.ndarray, tp.List[Event]]:
        sample_rate = self.render_sample_rate
        n_times = sample_rate.to_ind(stop - start)
        data = np.zeros((self.dimension, n_times), dtype=np.float32)
        mask = np.zeros((1, n_times), dtype=bool)

        for feature in self.values():
            data[self.get_slice(feature.name)] = feature.default_value

        select = (self.events["_stop"] >= start) \
            & (self.events["start"] < stop)
        dslice = DataSlice(start=start, duration=stop - start,
                           sample_rate=sample_rate, language=None,
                           modality=None)
        event_list: tp.List[Event] = [dslice]
        for event in self.events[select].iter():
            event_list.append(event)
            overlap = dslice.overlap(event)
            if overlap.duration_ind < 1:
                continue
            for feature in self.values():
                if feature.event_kind == event.kind:
                    val = feature.get_on_overlap(event, overlap)
                    data[self.get_slice(feature.name),
                         overlap.slice_in_parent()] = val
            if self.event_mask and \
                    self.word_seg_feature.event_kind == event.kind:
                mask[:, overlap.slice_in_parent()] = bool(
                    self.word_seg_feature.get(event))

        for feature in self.values():
            feature.post_process(data[self.get_slice(feature.name)])

        if not self.event_mask:
            mask[:, :] = True
        return data, mask, event_list

    def __reduce__(self) -> tp.Any:
        """Pickle as a plain object (an OrderedDict subclass would re-enter
        __init__ without arguments)."""
        return object.__reduce__(self)

    def backends(self) -> tp.Dict[str, tp.Any]:
        """{name: what computes it} for each feature that has a model or an
        offline stand-in (``Feature.backend``), over the languages of its
        events: a track cache key that holds it is not served once a model
        appears on disk or goes."""
        out = {}
        for name, feature in self.items():
            if not hasattr(feature, "backend"):
                continue
            languages = {event.language or "en" for event in self.events[
                self.events.kind_mask(feature.event_kind)].iter()}
            out[name] = feature.backend(sorted(languages))
        return out

    def render_track(self, duration: float
                     ) -> tp.Tuple[np.ndarray, np.ndarray]:
        """The [0, duration) features and mask, painted once."""
        data, mask, _ = self(0.0, duration)
        return data, mask
