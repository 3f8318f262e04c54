"""Shared helpers of the study adapters.

Port of ``brainmagick_tpu/studies/utils.py``: a study's root folder from
``env.studies``, and the Levenshtein alignment of two sequences; and, in
place of pandas, ``read_csv``, which types a text table's columns as
pandas' reader does.
"""

from __future__ import annotations

import csv
import math
import re
import typing as tp
from pathlib import Path

import numpy as np

from ..env import env


class StudyPaths:
    """A study's root (``env.studies[name]``, from
    ``BM_TPU_STUDY_<NAME>``) and its ``download`` folder."""

    def __init__(self, study_name: str) -> None:
        if study_name not in env.studies:
            raise EnvironmentError(
                f"No data path configured for study '{study_name}'. Set "
                f"env.studies['{study_name}'] or BM_TPU_STUDY_"
                f"{study_name.upper()} to the dataset root.")
        self.path = Path(env.studies[study_name])
        self.download = self.path / "download"


def match_list(A: tp.Sequence[tp.Any], B: tp.Sequence[tp.Any]
               ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """The index pairs of the elements that a Levenshtein alignment of
    `A` with `B` keeps as exact matches (compared as strings), by an
    O(len(A) len(B)) dynamic programme and its backtrack."""
    A = [str(a) for a in A]
    B = [str(b) for b in B]
    n, m = len(A), len(B)
    dist = np.zeros((n + 1, m + 1), dtype=np.int32)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        ai = A[i - 1]
        row = dist[i]
        prev = dist[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ai != B[j - 1])
            row[j] = min(sub, prev[j] + 1, row[j - 1] + 1)
    i, j = n, m
    a_idx: tp.List[int] = []
    b_idx: tp.List[int] = []
    while i > 0 and j > 0:
        sub = dist[i - 1, j - 1] + (A[i - 1] != B[j - 1])
        if sub <= dist[i - 1, j] + 1 and sub <= dist[i, j - 1] + 1:
            if A[i - 1] == B[j - 1]:
                a_idx.append(i - 1)
                b_idx.append(j - 1)
            i, j = i - 1, j - 1
        elif dist[i - 1, j] < dist[i, j - 1]:
            i -= 1
        else:
            j -= 1
    return np.array(a_idx[::-1]), np.array(b_idx[::-1])


#: the cells pandas' read_csv reads as missing (its default na_values)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*")
_POWERS = [float(f"1e{k}") for k in range(309)]


def parse_float(text: str) -> float:
    """`text` as pandas' read_csv parses a float (its default
    'precise_xstrtod'): the first 17 significant digits accumulated in a
    double, then one multiplication or division by a power of ten. It
    differs from ``float(text)`` in the last bit for some 17-digit
    decimals."""
    match = _FLOAT.fullmatch(text)
    if match is None or not (match.group(2) or match.group(3)):
        word = text.strip().lower().lstrip("+")
        if word in ("inf", "infinity", "-inf", "-infinity"):
            return float(word)
        raise ValueError(f"could not convert string to float: {text!r}")
    sign, integer, decimals, exp = match.groups()
    number, digits, exponent = 0., 0, 0
    for c in integer:
        if digits < 17:
            number = number * 10. + (ord(c) - 48)
            digits += 1
        else:
            exponent += 1
    for c in decimals or "":
        if digits >= 17:
            break
        number = number * 10. + (ord(c) - 48)
        digits += 1
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp or 0)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POWERS[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0. * number
        return number / _POWERS[-308 - exponent] / _POWERS[308]
    return number / _POWERS[-exponent]


def _typed_column(cells: tp.List[str]) -> tp.List[tp.Any]:
    """A column of text cells typed as pandas' read_csv types it: ints
    (when none is missing), else floats (NaN where missing), else bools,
    else the strings (NaN where missing)."""
    missing = [c in NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if present and not any(missing) \
            and all(_INT.fullmatch(c) for c in present):
        return [int(c) for c in cells]
    try:
        return [math.nan if m else parse_float(c)
                for c, m in zip(cells, missing)]
    except ValueError:
        pass
    if present and all(c in ("True", "False", "TRUE", "FALSE", "true",
                             "false") for c in present):
        return [math.nan if m else c.lower() == "true"
                for c, m in zip(cells, missing)]
    return [math.nan if m else c for c, m in zip(cells, missing)]


def read_csv(path: tp.Union[str, Path], sep: str = ","
             ) -> tp.List[tp.Dict[str, tp.Any]]:
    """The rows of a delimited text file with a header line, as dicts of
    typed values (``_typed_column``; NaN where missing), in the order of
    the file: what ``pd.read_csv(path, sep=sep).to_dict("records")``
    gives."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=sep)
        header = next(reader)
        cells = [row + [""] * (len(header) - len(row)) for row in reader
                 if row]
    columns = [_typed_column([row[k] for row in cells])
               for k in range(len(header))]
    return [dict(zip(header, values)) for values in zip(*columns)] \
        if cells else []
