"""Word-level features: word vectors, part of speech, BERT and XLM-R.

Port of ``brainmagick_tpu/features/embeddings.py``, with the same feature
surface and widths (WordEmbedding 300, WordEmbeddingSmall 96,
PartOfSpeech 21 classes, BertEmbedding 768, XlmEmbedding 1024).

Each feature uses its model when the model is on local disk (a spacy
package; a ``transformers`` checkpoint in the local cache, read with
``HF_HUB_OFFLINE=1``) and otherwise its deterministic stand-in: a unit
normal vector seeded by the sha1 of the word (``hash_embedding``), or a
rule-based tagger (``rule_based_pos``). The stand-in is gated:
``features_params.<Feature>.allow_fallback`` decides when set; unset,
``FeaturesBuilder`` allows it for the synthetic studies only, so a real
study with a missing model raises ``MissingModelError`` instead of
training on hash embeddings. ``backend`` names what a feature computes
with, for the track cache's key.

spacy and transformers are imported inside the functions that use them:
neither is needed to import the port.
"""

from __future__ import annotations

import hashlib
import logging
import os
import typing as tp

import numpy as np
import torch

from .. import events
from ..cache import MemoryCache
from ..utils import Frequency
from .base import Feature

logger = logging.getLogger(__name__)

#: the universal POS tag set (spacy's), 20 tags; class 0 is silence
UPOS_TAGS = ("ADJ", "ADP", "ADV", "AUX", "CCONJ", "DET", "INTJ", "NOUN",
             "NUM", "PART", "PRON", "PROPN", "PUNCT", "SCONJ", "SYM",
             "VERB", "X", "EOL", "SPACE", "OTHER")

_SPACY_MODELS = {"en": "en_core_web_md", "nl": "nl_core_news_md",
                 "english": "en_core_web_md", "dutch": "nl_core_news_md"}

#: what ``backend`` names for the offline stand-ins
FALLBACK = "fallback"


def _spacy_model(lang: str) -> str:
    return _SPACY_MODELS.get(lang, f"{lang}_core_news_md")


def _try_spacy(lang: str):
    """The spacy pipeline of `lang` when its package is installed, else
    None (spacy absent included)."""
    try:
        import spacy
        model = _spacy_model(lang)
        if spacy.util.is_package(model):
            return spacy.load(model)
    except ImportError:
        pass
    return None


class MissingModelError(RuntimeError):
    """A real study needs a model that is not on local disk, and its
    offline stand-in was not explicitly allowed."""


def _check_fallback(feature: Feature, what: str, instruction: str) -> None:
    """Raise unless `feature` may fall back (None, direct library use,
    allows it; ``FeaturesBuilder`` resolves None per study)."""
    allowed = getattr(feature, "allow_fallback", None)
    if allowed is None:
        allowed = True
    if not allowed:
        raise MissingModelError(
            f"{feature.name}: {what} is not available on local disk and "
            f"this is a real study, so the deterministic-fallback path "
            f"is disabled. {instruction} Or opt into the fallback with "
            f"dset.features_params.{feature.name}.allow_fallback=true "
            f"(trains on hash embeddings — not the paper recipe).")


def hash_embedding(word: str, dim: int) -> np.ndarray:
    """A word's deterministic unit-normal vector: the first 4 bytes of the
    sha1 of the lower-cased word seed ``RandomState``, whose ``randn``
    gives the vector, divided by its norm."""
    seed = int.from_bytes(
        hashlib.sha1(word.lower().encode()).digest()[:4], "little")
    rng = np.random.RandomState(seed)
    vec = rng.randn(dim).astype(np.float32)
    return vec / np.linalg.norm(vec)


class _SpacyFeature(Feature):
    """A word feature computed by spacy's pipeline of the word's language
    (``lang``, or the event's when "auto")."""

    event_kind = "word"

    def __init__(self, sample_rate: Frequency, lang: str = "auto",
                 allow_fallback: tp.Optional[bool] = None) -> None:
        super().__init__(sample_rate)
        self.lang = lang
        self.allow_fallback = allow_fallback
        self._nlp_cache = MemoryCache("spacy", self.name)
        self._warned = False

    def _language(self, event: events.Word) -> str:
        return self.lang if self.lang != "auto" \
            else (event.language or "en")

    def _nlp(self, language: str):
        return self._nlp_cache.get(_try_spacy, language)

    def _refuse_fallback(self, language: str) -> None:
        _check_fallback(
            self, f"the spacy model for lang={language}",
            f"Install it with `python -m spacy download "
            f"{_spacy_model(language)}`.")

    def backend(self, languages: tp.Sequence[str]) -> tp.Dict[str, str]:
        """{language: the spacy model, or FALLBACK} over `languages` (the
        events' languages, "en" for none)."""
        if self.lang != "auto":
            languages = [self.lang]
        return {lang: _spacy_model(lang) if self._nlp(lang) is not None
                else FALLBACK for lang in languages}


class _WordEmbeddingBase(_SpacyFeature):
    """A word's vector painted over the word's span."""

    dimension = 300

    def _embed(self, word: str, language: str) -> np.ndarray:
        nlp = self._nlp(language)
        if nlp is not None:
            vec = nlp(word).vector[:self.dimension]
            if vec.shape[0] == self.dimension and np.any(vec):
                return np.asarray(vec, dtype=np.float32)
            # the model is there but the word is out of its vocabulary
            # (a zero vector): a per-word stand-in, not a missing model
            return hash_embedding(word, self.dimension)
        self._refuse_fallback(language)
        if not self._warned:
            logger.warning(
                "%s: no spacy model for lang=%s on disk; using "
                "deterministic hash embeddings.", self.name, language)
            self._warned = True
        return hash_embedding(word, self.dimension)

    def get(self, event: events.Word) -> np.ndarray:
        return self._embed(event.word, self._language(event))


class WordEmbedding(_WordEmbeddingBase):
    """The 300-d spacy (md) word vector."""
    dimension = 300


class WordEmbeddingSmall(_WordEmbeddingBase):
    """The first 96 dimensions of the spacy word vector."""
    dimension = 96


#: closed-class words and suffix rules of the offline tagger
_CLOSED_CLASS = {
    "en": {"the": "DET", "a": "DET", "an": "DET", "and": "CCONJ",
           "or": "CCONJ", "but": "CCONJ", "in": "ADP", "on": "ADP",
           "at": "ADP", "of": "ADP", "to": "PART", "is": "AUX",
           "are": "AUX", "was": "AUX", "were": "AUX", "be": "AUX",
           "he": "PRON", "she": "PRON", "it": "PRON", "they": "PRON",
           "i": "PRON", "you": "PRON", "we": "PRON", "that": "SCONJ",
           "not": "PART"},
    "nl": {"de": "DET", "het": "DET", "een": "DET", "en": "CCONJ",
           "of": "CCONJ", "maar": "CCONJ", "in": "ADP", "op": "ADP",
           "van": "ADP", "te": "PART", "is": "AUX", "zijn": "AUX",
           "was": "AUX", "hij": "PRON", "zij": "PRON", "ik": "PRON",
           "dat": "SCONJ", "niet": "PART"},
}


def rule_based_pos(word: str, language: str) -> str:
    """The offline tagger: closed classes, digits, punctuation, English
    -ing/-ed verbs and -ly adverbs, capitalized proper nouns, else NOUN."""
    lang = {"english": "en", "dutch": "nl"}.get(language, language)
    w = word.lower()
    closed = _CLOSED_CLASS.get(lang, _CLOSED_CLASS["en"])
    if w in closed:
        return closed[w]
    if w.isdigit():
        return "NUM"
    if not w.isalpha():
        return "PUNCT" if not any(c.isalnum() for c in w) else "X"
    if lang == "en" and (w.endswith("ing") or w.endswith("ed")):
        return "VERB"
    if lang == "en" and w.endswith("ly"):
        return "ADV"
    if word[:1].isupper():
        return "PROPN"
    return "NOUN"


class PartOfSpeech(_SpacyFeature):
    """The word's UPOS tag as a class (21 classes, 0 = silence)."""

    cardinality = len(UPOS_TAGS) + 1

    def get(self, event: events.Word) -> int:
        language = self._language(event)
        nlp = self._nlp(language)
        if nlp is not None:
            tag = nlp(event.word)[0].pos_
        else:
            self._refuse_fallback(language)
            if not self._warned:
                logger.warning("PartOfSpeech: no spacy model on disk; "
                               "using rule-based tagger.")
                self._warned = True
            tag = rule_based_pos(event.word, language)
        idx = UPOS_TAGS.index(tag) if tag in UPOS_TAGS \
            else UPOS_TAGS.index("OTHER")
        return idx + 1


class _ContextualEmbeddingBase(Feature):
    """Transformer word embeddings: the whole word sequence runs through
    the model once, and a word's vector pools the tokens whose character
    offsets fall inside the word."""

    event_kind = "word"
    model_name = ""
    #: hidden-state layers averaged before the token pooling; None = last
    layers: tp.Optional[tp.Tuple[int, ...]] = None
    #: "sum" (keeps the word's length) or "sum_sqrt" (the sum over the
    #: square root of the token count)
    token_pooling = "sum"

    def __init__(self, sample_rate: Frequency, contextual: bool = True,
                 allow_fallback: tp.Optional[bool] = None) -> None:
        super().__init__(sample_rate)
        self.contextual = contextual
        self.allow_fallback = allow_fallback
        self._model_cache = MemoryCache(self.__class__.__name__, "model")
        self._seq_cache: tp.Dict[str, tp.Tuple[np.ndarray, np.ndarray]] = {}
        self._warned = False

    def _load(self):
        """(tokenizer, model) from the local cache, else None."""
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        try:
            from transformers import AutoModel, AutoTokenizer
            tok = AutoTokenizer.from_pretrained(self.model_name)
            model = AutoModel.from_pretrained(self.model_name)
            model.eval()
            return tok, model
        except Exception:  # no transformers, or no checkpoint on disk
            return None

    def _model(self):
        return self._model_cache.get(self._load)

    def backend(self, languages: tp.Sequence[str]) -> str:
        """The checkpoint's name, or FALLBACK."""
        return self.model_name if self._model() is not None else FALLBACK

    def _hiddens(self, sequence: str) -> tp.Tuple[np.ndarray, np.ndarray]:
        """[n_tokens, D] pooled hidden states and [n_tokens, 2] character
        offsets of one sequence, kept for the sequence's other words."""
        if sequence in self._seq_cache:
            return self._seq_cache[sequence]
        tok, model = self._model()
        inputs = tok(sequence, return_offsets_mapping=True,
                     return_tensors="pt", add_special_tokens=True)
        with torch.no_grad():
            out = model(
                input_ids=inputs["input_ids"],
                attention_mask=inputs.get("attention_mask"),
                output_hidden_states=True)
        hs = torch.stack(out.hidden_states)[:, 0]  # [L + 1, n_tok, D]
        if not self.contextual:
            pooled = hs[0]                         # the embedding layer
        elif self.layers is not None:
            idx = [k for k in self.layers if k < hs.shape[0]] or [-1]
            pooled = hs[idx].mean(0)
        else:
            pooled = hs[-1]
        value = (pooled.numpy().astype(np.float32),
                 inputs["offset_mapping"][0].numpy())
        if len(self._seq_cache) > 512:  # bounds host memory
            self._seq_cache.clear()
        self._seq_cache[sequence] = value
        return value

    def _word_span(self, event: events.Word
                   ) -> tp.Optional[tp.Tuple[int, int]]:
        """The word's character span in its space-joined sequence, from
        ``word_index``; None when the index does not point at the word
        (the whole sequence is pooled then)."""
        sequence = event.word_sequence or ""
        words = sequence.split(" ")
        wid = int(event.word_index or 0)
        if not (0 <= wid < len(words)) or words[wid] != event.word:
            return None
        char_end = len(" ".join(words[:wid + 1]))
        char_start = char_end - len(event.word)
        if sequence[char_start:char_end] != event.word:
            return None
        return char_start, char_end

    def get(self, event: events.Word) -> np.ndarray:
        if not event.word:
            return np.zeros(self.dimension, dtype=np.float32)
        if self._model() is None:
            _check_fallback(
                self, f"the {self.model_name} checkpoint",
                f"Fetch it once on a connected machine with "
                f"`python -c \"from transformers import AutoModel, "
                f"AutoTokenizer; AutoModel.from_pretrained("
                f"'{self.model_name}'); AutoTokenizer.from_pretrained("
                f"'{self.model_name}')\"`.")
            if not self._warned:
                logger.warning(
                    "%s: checkpoint %s not on local disk; using "
                    "deterministic hash embeddings.", self.name,
                    self.model_name)
                self._warned = True
            return hash_embedding(event.word, self.dimension)
        sequence = event.word_sequence or event.word
        hiddens, offsets = self._hiddens(sequence)
        span = self._word_span(event)
        if span is None:
            logger.info("Bad word_index for word %r in sequence %r",
                        event.word, sequence)
            mask = offsets[:, 1] > offsets[:, 0]   # every non-special token
        else:
            char_start, char_end = span
            mask = ((offsets[:, 1] > char_start)
                    & (offsets[:, 0] < char_end)
                    & (offsets[:, 1] > offsets[:, 0]))
        picked = hiddens[mask]
        if not len(picked):
            return np.zeros(self.dimension, dtype=np.float32)
        out = picked.sum(0)
        if self.token_pooling == "sum_sqrt":
            out = out / np.sqrt(len(picked))
        return out.astype(np.float32)


class BertEmbedding(_ContextualEmbeddingBase):
    """Multilingual BERT, 768-d: the mean of layers 8-10, the word's
    tokens summed."""
    dimension = 768
    model_name = "bert-base-multilingual-cased"
    layers = (8, 9, 10)
    token_pooling = "sum"


class XlmEmbedding(_ContextualEmbeddingBase):
    """XLM-R large, 1024-d: the last layer when `contextual`, else the
    embedding layer; the word's tokens summed over the square root of
    their count."""
    dimension = 1024
    model_name = "xlm-roberta-large"
    layers = None
    token_pooling = "sum_sqrt"

    def __init__(self, sample_rate: Frequency, contextual: bool = False,
                 allow_fallback: tp.Optional[bool] = None) -> None:
        super().__init__(sample_rate, contextual=contextual,
                         allow_fallback=allow_fallback)
