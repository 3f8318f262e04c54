"""Shared helpers of the data path.

Port of ``brainmagick_tpu/utils/misc.py``: ``Frequency``, ``roundrobin``
and ``write_and_rename``.
"""

from __future__ import annotations

import itertools
import os
import threading
import typing as tp
from contextlib import contextmanager
from pathlib import Path

import numpy as np

X = tp.TypeVar("X")


class Frequency(float):
    """A float sample rate with second <-> sample-index conversions.

    The rounding (round half to even, through ``np.round`` and the builtin
    ``round``) decides segment starts and the alignment of the feature
    tracks with the recording, so it must be the same everywhere."""

    def to_ind(self, seconds: tp.Any) -> tp.Any:
        """A time in seconds (scalar or array) as a sample index."""
        if isinstance(seconds, np.ndarray):
            return np.round(seconds * self).astype(int)
        return int(round(seconds * self))

    def to_sec(self, index: tp.Any) -> tp.Any:
        """A sample index (scalar or array) as a time in seconds."""
        return index / self


def roundrobin(*iterables: tp.Iterable[X]) -> tp.Iterator[X]:
    """roundrobin('ABC', 'D', 'EF') --> A D E B F C (itertools recipe)."""
    num_active = len(iterables)
    nexts = itertools.cycle(iter(it).__next__ for it in iterables)
    while num_active:
        try:
            for nxt in nexts:
                yield nxt()
        except StopIteration:
            num_active -= 1
            nexts = itertools.cycle(itertools.islice(nexts, num_active))


@contextmanager
def write_and_rename(path: tp.Union[str, Path], mode: str = "wb"):
    """Write to a temporary file named after this process and thread, then
    rename it onto `path`, so that no reader sees a half-written file."""
    tmp_path = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp_path, mode) as f:
        yield f
    os.rename(tmp_path, str(path))
