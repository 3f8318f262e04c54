"""Stimulus features, painted onto dense [D, T] tracks.

Port of ``brainmagick_tpu/features``: the builder, the word and phoneme
features and the mel spectrogram. The pitch, wav2vec 2.0 and word
embedding features are not ported yet (see ``audio``).
"""

from .base import Feature, FeaturesBuilder  # noqa
from . import basic  # noqa
from . import audio  # noqa
