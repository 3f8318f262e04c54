"""Studies and the Recording API.

Port of ``brainmagick_tpu/studies``: the API and the synthetic ``fake``
study. The other studies read data files from disk and are not ported
yet; selecting one raises KeyError.
"""

from .api import (INVALID_POSITION, RawData, Recording,  # noqa
                  from_selection, register)
from . import fake  # noqa
