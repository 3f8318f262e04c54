"""Studies and the Recording API.

Port of ``brainmagick_tpu/studies``: the API, the synthetic ``fake`` and
``fakeeeg`` studies, and the paper's four datasets (gwilliams2022,
schoffelen2019, brennan2019, broderick2019), read from their on-disk
formats (KIT ``.con``, CTF ``.ds``, FIF, MATLAB, TextGrid, gentle JSON)
by the port's own readers. Importing the package registers every study.
"""

from .api import (INVALID_POSITION, RawData, Recording,  # noqa
                  from_selection, list_selections, register)
from . import fake  # noqa
from . import fakeeeg  # noqa
from . import gwilliams2022  # noqa
from . import brennan2019  # noqa
from . import broderick2019  # noqa
from . import schoffelen2019  # noqa
