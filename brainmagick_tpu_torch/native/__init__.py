"""Host code of the port in C++, bound with ctypes.

``gather`` assembles a batch's epochs and feature windows from the
recordings' memmaps in float32 or straight in bfloat16 (``gather.cpp``,
built with g++ at first use into the package's ``_build/``).
"""

from .gather import GatherBuildError, gather_epochs, gather_track  # noqa
