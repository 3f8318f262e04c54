"""Shared helpers of the data path.

Port of ``brainmagick_tpu/utils/misc.py``: ``Frequency``, ``roundrobin``
and ``write_and_rename``; ``dump_yaml``, which writes a config as
PyYAML's ``safe_dump`` does (the card's host has no PyYAML);
``records_csv``, which writes a list of dicts as pandas' ``to_csv``
does (nor pandas); and ``as_tensor``/``transfer``, the host -> device
copy of the batches and of a serving artifact's inputs.
"""

from __future__ import annotations

import csv
import io
import itertools
import math
import os
import re
import threading
import typing as tp
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from . import tracing

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


def _is_missing(value: tp.Any) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def _csv_column(values: tp.List[tp.Any]) -> tp.List[str]:
    """One column's cells as pandas writes the column it infers from
    `values`: ints (none missing) as ints, numbers as float64 (an int as
    ``3.0``, a missing value empty), anything else as ``str`` (a missing
    value empty)."""
    present = [v for v in values if not _is_missing(v)]
    numbers = [v for v in present if not isinstance(v, bool)
               and isinstance(v, (int, float, np.integer, np.floating))]
    if present and len(numbers) == len(values) and all(
            isinstance(v, (int, np.integer)) for v in numbers):
        return [str(int(v)) for v in values]
    if present and len(numbers) == len(present):
        return ["" if _is_missing(v) else repr(float(v)) for v in values]
    return ["" if _is_missing(v) else str(v) for v in values]


def records_csv(rows: tp.Sequence[tp.Mapping[str, tp.Any]]) -> str:
    """The text of ``pd.DataFrame(rows).to_csv(index=False)``: the columns
    in the order their keys first appear, a key a row lacks as missing,
    each column typed as ``_csv_column`` says, quoted as the csv module
    quotes."""
    keys: tp.List[str] = []
    for row in rows:
        keys.extend(k for k in row if k not in keys)
    columns = [_csv_column([row.get(k) for row in rows]) for k in keys]
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow(keys)
    writer.writerows(zip(*columns))
    return buf.getvalue()


#: the scalars YAML 1.1 resolves to another type than str when plain
#: (PyYAML's implicit resolvers: bool, float, int, merge, null, timestamp
#: and value); such a string is single-quoted
_YAML_IMPLICIT = re.compile(r"""(?:
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
    |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |<<|~|null|Null|NULL|=
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)""", re.X)
#: PyYAML's line width: it folds a scalar at a space past this column
_YAML_WIDTH = 80
#: PyYAML writes an empty key, or one of this length or more, as a
#: complex key
_YAML_KEY_LENGTH = 128


def _yaml_plain(text: str) -> bool:
    """Whether PyYAML writes `text` (printable ASCII on one line) as a
    plain scalar in block context, else single-quoted."""
    if not text or _YAML_IMPLICIT.fullmatch(text) \
            or text.startswith(("---", "...")) or " " in (text[0], text[-1]):
        return False
    if text[0] in "#,[]{}&*!|>'\"%@`" \
            or (text[0] in "?:-" and text[1:2] in ("", " ")):
        return False
    return not any(ch == ":" and text[i + 1:i + 2] in ("", " ")
                   or ch == "#" and text[i - 1] == " "
                   for i, ch in enumerate(text) if i)


def _yaml_scalar(value: tp.Any, column: int, key: bool = False) -> str:
    """A scalar as PyYAML's SafeDumper writes it, starting at `column`."""
    kind = type(value)
    if value is None:
        return "null"
    if kind is bool:
        return "true" if value else "false"
    if kind is int:
        return str(value)
    if kind is float:
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if kind is not str:
        raise TypeError(f"dump_yaml cannot write {kind.__name__}: "
                        f"{value!r}")
    if not all(" " <= ch <= "~" for ch in value):
        raise ValueError(f"dump_yaml writes printable ASCII on one line, "
                         f"not {value!r}")
    text = value if _yaml_plain(value) \
        else "'" + value.replace("'", "''") + "'"
    if key and not 0 < len(value) < _YAML_KEY_LENGTH \
            or not key and " " in value and column + len(text) > _YAML_WIDTH:
        raise ValueError(f"PyYAML would fold or key {value!r} otherwise")
    return text


def _yaml_block(value: tp.Any, indent: int, seen: set) -> tp.List[str]:
    """The lines of a non-empty dict (sorted keys) or list in block
    style, at `indent`."""
    if id(value) in seen:
        raise ValueError("dump_yaml writes no anchors: a dict or list "
                         "appears twice")
    seen.add(id(value))
    lines = []
    items = sorted(value.items()) if isinstance(value, dict) \
        else [(None, item) for item in value]
    for key, item in items:
        if key is None:
            head = " " * indent + "- "
        else:
            if type(key) is not str:
                raise TypeError(f"dump_yaml writes str keys, not {key!r}")
            head = " " * indent + _yaml_scalar(key, indent, key=True) + ":"
        if type(item) in (dict, list, tuple) and item:
            if key is None:
                sub = _yaml_block(item, indent + 2, seen)
                lines += [head + sub[0][indent + 2:]] + sub[1:]
            else:
                # a list under a key is not indented (PyYAML's
                # indentless sequence)
                lines += [head] + _yaml_block(
                    item, indent + 2 * (type(item) is dict), seen)
        else:
            if key is not None:
                head += " "
            if type(item) in (dict, list, tuple):
                if id(item) in seen and type(item) is not tuple:
                    raise ValueError("dump_yaml writes no anchors: a dict "
                                     "or list appears twice")
                seen.add(id(item))
                text = "{}" if type(item) is dict else "[]"
            else:
                text = _yaml_scalar(item, len(head))
            lines.append(head + text)
    return lines


def dump_yaml(obj: tp.Any, f: tp.TextIO) -> None:
    """Write `obj` (a dict or a list of dicts, lists, str, int, float,
    bool and None, as ``dataclasses.asdict`` of a config gives) to `f` as
    ``yaml.safe_dump(obj, f, default_flow_style=False)`` writes it. Any
    other type raises TypeError; a string that PyYAML would write in
    another style than plain or single-quoted on one line (a newline, a
    character outside printable ASCII, a fold past the line width, a
    complex key) raises ValueError, as does a container that appears
    twice (PyYAML would write an anchor)."""
    if type(obj) not in (dict, list, tuple):
        raise TypeError(f"dump_yaml writes a dict or a list, not "
                        f"{type(obj).__name__}")
    if not obj:
        f.write("{}\n" if type(obj) is dict else "[]\n")
        return
    f.write("".join(line + "\n" for line in _yaml_block(obj, 0, set())))


def as_tensor(value: tp.Any) -> torch.Tensor:
    """A tensor as it is; an array-like as a CPU tensor of its bits
    (ml_dtypes bfloat16, the JAX package's wire format, as torch's)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.ascontiguousarray(np.asarray(value))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def transfer(value: tp.Any, device: torch.device,
             dtype: tp.Optional[torch.dtype] = None,
             buffers: tp.Optional[tp.Dict[str, torch.Tensor]] = None,
             name: str = "") -> torch.Tensor:
    """`value` (numpy or a tensor) on `device` in `dtype` (its own when
    None). From the host to a CUDA device it is copied once on the host,
    into page-locked memory, casting as it goes, and the transfer is
    non-blocking on the current stream; `buffers` (by `name`) holds the
    page-locked buffer to reuse, which the caller must not touch again
    before that transfer has finished. Each copy to the card adds to the
    counters ``h2d.copies`` and ``h2d.bytes`` (``tracing.count``)."""
    tensor = as_tensor(value)
    dtype = dtype or tensor.dtype
    if device.type != "cuda" or tensor.device.type == "cuda":
        return tensor.to(device=device, dtype=dtype)   # itself when no-op
    pinned = None if buffers is None else buffers.get(name)
    if pinned is None or pinned.shape != tensor.shape \
            or pinned.dtype != dtype:
        pinned = torch.empty(tensor.shape, dtype=dtype, pin_memory=True)
        if buffers is not None:
            buffers[name] = pinned
    tracing.count("h2d.copies")
    tracing.count("h2d.bytes", pinned.numel() * pinned.element_size())
    return pinned.copy_(tensor).to(device, non_blocking=True)
