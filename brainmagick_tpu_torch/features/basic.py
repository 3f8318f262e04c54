"""Word and phoneme features: scalars, categoricals and pulses.

Port of ``brainmagick_tpu/features/basic.py``: the same nine features,
the same cardinalities and id conventions (0 is silence).
"""

from __future__ import annotations

import hashlib
import typing as tp

import numpy as np

from .. import events
from ..phonemes import ph_dict
from ..utils import Frequency
from .base import Feature

# Approximate Zipf frequencies of the most common function words (the
# JAX package's table, which it uses without the `wordfreq` package; the
# port never uses `wordfreq`). Other words get an estimate from their
# length (Zipf's law of abbreviation).
_ZIPF_TABLE = {
    "en": {"the": 7.7, "of": 7.1, "and": 7.1, "to": 7.1, "a": 7.0, "in": 6.9,
           "is": 6.6, "that": 6.5, "it": 6.6, "was": 6.4, "i": 6.8, "for": 6.6,
           "on": 6.5, "you": 6.7, "he": 6.4, "be": 6.4, "with": 6.4, "as": 6.3,
           "by": 6.2, "at": 6.3, "have": 6.3, "are": 6.3, "this": 6.3,
           "not": 6.4, "but": 6.3, "had": 6.0, "his": 6.1, "they": 6.2,
           "from": 6.2, "she": 6.1, "her": 6.1, "or": 6.2, "an": 6.1,
           "were": 5.9, "we": 6.3, "their": 5.9, "been": 5.8, "has": 6.0,
           "would": 6.0, "there": 6.1, "what": 6.2, "so": 6.3, "up": 6.2,
           "out": 6.2, "if": 6.2, "about": 6.1, "who": 6.0, "get": 6.1,
           "which": 5.9, "go": 6.0, "me": 6.3, "when": 6.1, "can": 6.2,
           "like": 6.2, "no": 6.3, "just": 6.2, "him": 6.0, "know": 6.1,
           "said": 5.9, "do": 6.3, "all": 6.3, "one": 6.3, "my": 6.4},
    "nl": {"de": 7.6, "en": 7.2, "van": 7.2, "het": 7.2, "een": 7.2, "in": 7.0,
           "is": 6.9, "dat": 6.9, "op": 6.7, "te": 6.8, "die": 6.7, "niet": 6.7,
           "met": 6.7, "zijn": 6.6, "voor": 6.6, "ik": 6.9, "je": 6.9,
           "er": 6.6, "aan": 6.5, "ook": 6.4, "als": 6.5, "dan": 6.3,
           "maar": 6.4, "om": 6.5, "bij": 6.3, "naar": 6.3, "uit": 6.2,
           "door": 6.2, "over": 6.2, "ze": 6.5, "hij": 6.4, "nog": 6.3,
           "wat": 6.4, "al": 6.3, "zo": 6.4, "kan": 6.3, "toen": 5.9,
           "heeft": 6.2, "wordt": 6.0, "deze": 6.1, "we": 6.6, "was": 6.5},
}
_LANG_ALIASES = {"english": "en", "dutch": "nl"}


def zipf_frequency(word: str, language: str) -> float:
    """Zipf frequency of a word, from the table above, else estimated from
    its length."""
    lang = _LANG_ALIASES.get(language, language)
    table = _ZIPF_TABLE.get(lang, _ZIPF_TABLE["en"])
    w = word.lower().strip(".,!?;:'\"")
    if w in table:
        return table[w]
    # length-based fallback: ~4.9 for 3 letters down to ~2 for 14+
    return float(np.clip(5.5 - 0.25 * len(w), 1.5, 5.2))


class WordPulse(Feature):
    """Box pulse of `duration_ms` at each word onset."""
    event_kind = "word"
    normalizable = False

    def __init__(self, sample_rate: Frequency, duration_ms: float = 50.) -> None:
        super().__init__(sample_rate)
        self.duration_ms = duration_ms

    def get(self, event: events.Word) -> np.ndarray:
        length = max(1, self.sample_rate.to_ind(event.duration))
        pulse = self.sample_rate.to_ind(self.duration_ms / 1000)
        out = np.zeros((1, length), dtype=np.float32)
        out[:, :pulse] = 1
        return out


class PhonemePulse(Feature):
    """Pulse at each phoneme *change* (edge detection in post_process)."""
    event_kind = "phoneme"
    normalizable = False

    def __init__(self, sample_rate: Frequency, duration_ms: float = 16) -> None:
        super().__init__(sample_rate)
        self.duration_ms = duration_ms

    def get(self, event: events.Phoneme) -> int:
        # paint the raw id (+1, 0 = silence); edges become pulses later
        return int(event.phoneme_id) + 1

    def post_process(self, block: np.ndarray) -> None:
        """[0,0,2,2,2,5,5,...] -> 1s at change points, widened to the
        pulse length."""
        row = block[0]
        changed = np.empty_like(row, dtype=bool)
        changed[0] = row[0] != 0
        changed[1:] = (row[1:] != row[:-1]) & (row[1:] != 0)
        pulse_len = max(1, int(self.duration_ms * self.sample_rate / 1000))
        pulses = np.zeros_like(row)
        idx = np.flatnonzero(changed)
        for k in range(pulse_len):
            pos = idx + k
            pos = pos[pos < len(row) - (pulse_len - 1) + k]
            pulses[pos] = 1
        block[0] = pulses


class WordSegment(Feature):
    """1 wherever a word stimulus is present (binary categorical;
    also used for the event mask channel)."""
    cardinality = 2
    event_kind = "word"

    def get(self, event: events.Word) -> int:
        return 1


class Modality(Feature):
    """audio=1 / visual=2 categorical task flag."""
    cardinality = 3
    event_kind = "word"

    def get(self, event: events.Word) -> int:
        if event.modality == "audio":
            return 1
        if event.modality == "visual":
            return 2
        raise RuntimeError("Only audio and visual modalities are supported")


class WordLength(Feature):
    event_kind = "word"

    def get(self, event: events.Word) -> int:
        return len(event.word)


class WordIndex(Feature):
    event_kind = "word"

    def get(self, event: events.Word) -> int:
        return event.word_index + 1


class WordFrequency(Feature):
    event_kind = "word"

    def get(self, event: events.Word) -> float:
        assert event.language is not None
        return zipf_frequency(event.word, event.language)


class Phoneme(Feature):
    """Phoneme class id (+1; 0 = silence)."""
    cardinality = len(ph_dict) + 1
    event_kind = "phoneme"

    def get(self, event: events.Phoneme) -> int:
        pid = int(event.phoneme_id)
        assert 0 <= pid < self.cardinality - 1, \
            f"Phoneme ID={pid} outside cardinality {self.cardinality}"
        return pid + 1


def stable_word_hash(word: str) -> int:
    """Deterministic word hash (sha1-based: python's builtin hash() is
    salted per process)."""
    norm = word.lower().strip(".")
    return int.from_bytes(
        hashlib.sha1(norm.encode()).digest()[:8], "little", signed=True)


class WordHash(Feature):
    """Word identity hash (``stable_word_hash``), optionally bucketed into
    a categorical; the word-retrieval evaluation reads it."""
    normalizable = False
    event_kind = "word"

    def __init__(self, sample_rate: Frequency,
                 buckets: tp.Optional[int] = None) -> None:
        super().__init__(sample_rate)
        self.buckets = buckets
        if buckets is not None:
            self.cardinality = 1 + buckets

    def get(self, event: events.Word) -> float:
        hsh = stable_word_hash(event.word)
        if self.buckets is not None:
            hsh = 1 + (hsh % self.buckets)
        return float(hsh)
