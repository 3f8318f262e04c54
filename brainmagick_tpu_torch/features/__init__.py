"""Stimulus features, painted onto dense [D, T] tracks.

Port of ``brainmagick_tpu/features``: the builder, the word and phoneme
features, the word embeddings and part of speech (``embeddings``), the
mel spectrogram, the YIN pitch and the wav2vec 2.0 features with
random=True (``audio``).
"""

from .base import Feature, FeaturesBuilder  # noqa
from . import basic  # noqa
from . import audio  # noqa
from . import embeddings  # noqa
