"""Typed events, and a pandas-free table of them: validation, blocks and
the deterministic split assignment.

Port of ``brainmagick_tpu/events.py``, which keeps events in a pandas
DataFrame; the card's host has no pandas, so here they live in an
``EventTable``: one numpy column per field (float64 with NaN for missing
numbers, object with None for anything else), plus ``kind``. Every
operation the data path runs on the DataFrame has its counterpart with
the same result, row order included:

  * ``sort_by_start`` orders rows as pandas' ``sort_values("start")``
    does: ``np.argsort(kind="quicksort")``, which is not stable, so rows
    that share a start (a word and its phoneme) come out in pandas' order;
  * ``validate`` instantiates each row's event class, as the ``.event``
    accessor does, and ``iter`` yields the typed events;
  * ``create_blocks`` (block rows at sentence or sound starts, each with
    the uid of its contents), ``merge_blocks``, ``assign_blocks`` (the
    same sha256-seeded draw per block uid) and ``split_wav_as_block``
    (sound events cut at block boundaries, so that audio features cannot
    leak across splits);
  * ``query`` takes the subset of pandas' ``DataFrame.query`` that a
    config string can hold (``dset.condition``, schoffelen2019's
    ``events_filter``): comparisons, ``in`` lists, and ``and``/``or``/
    ``not`` with pandas' ``&``/``|``/``~``, over column names and
    literals, with pandas' rows.
"""

from __future__ import annotations

import ast
import hashlib
import io
import math
import operator
import random
import tokenize
import typing as tp
from dataclasses import asdict, dataclass, fields
from pathlib import Path

import numpy as np

from .utils import Frequency


# ---------------------------------------------------------------------------
# Typed event records
# ---------------------------------------------------------------------------

@dataclass
class Event:
    """Base event: a [start, start + duration) span."""
    start: float
    duration: float
    modality: tp.Optional[str]
    language: tp.Optional[str]

    def __post_init__(self) -> None:
        if self.duration < 0:
            raise ValueError("Negative durations are not allowed for events.")

    @classmethod
    def from_dict(cls, row: tp.Mapping[str, tp.Any]) -> "Event":
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in row.items() if k in names})

    @classmethod
    def kind_name(cls) -> str:
        return cls.__name__.lower()

    @property
    def kind(self) -> str:
        return self.kind_name()

    @property
    def stop(self) -> float:
        return self.start + self.duration


@dataclass
class DataSlice(Event):
    """A slice of the recording's timeline, with the overlap helpers the
    feature painter uses."""
    sample_rate: float

    def __post_init__(self) -> None:
        super().__post_init__()
        self._sample_rate = Frequency(self.sample_rate)
        self._parent: tp.Optional["DataSlice"] = None

    def overlap(self, event: Event) -> "DataSlice":
        start = max(self.start, event.start)
        stop = min(self.stop, event.stop)
        out = DataSlice(start=start, duration=stop - start,
                        sample_rate=self.sample_rate,
                        language=self.language, modality=self.modality)
        out._sample_rate = self._sample_rate
        out._parent = self
        return out

    def slice_in_parent(self) -> slice:
        assert self._parent is not None
        start = self.start_ind - self._parent.start_ind
        return slice(start, start + self.duration_ind)

    @property
    def start_ind(self) -> int:
        return self._sample_rate.to_ind(self.start)

    @property
    def stop_ind(self) -> int:
        return self._sample_rate.to_ind(self.stop)

    @property
    def duration_ind(self) -> int:
        return self.stop_ind - self.start_ind


def _wav_duration(filepath: str) -> float:
    """Duration in seconds of a PCM wav file."""
    import wave
    with wave.open(filepath, "rb") as f:
        return f.getnframes() / f.getframerate()


def _missing(value: tp.Any) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


@dataclass
class Sound(Event):
    """An audio stimulus from a file; the duration is clamped to the file's
    length past `offset`."""
    filepath: str
    offset: float = 0.0

    def __post_init__(self) -> None:
        super().__post_init__()
        self.filepath = str(Path(self.filepath).absolute())
        if _missing(self.offset):
            self.offset = 0.0
        if "MOCK_CACHE" in self.filepath:
            assert self.duration is not None
        else:
            assert Path(self.filepath).exists(), \
                f"{self.filepath} does not exist."
            actual = _wav_duration(self.filepath) - self.offset
            if self.duration is None or self.duration == 0:
                self.duration = actual
            else:
                self.duration = min(actual, self.duration)


@dataclass
class Word(Event):
    word: str
    word_index: int
    word_sequence: str

    def __post_init__(self) -> None:
        super().__post_init__()
        assert self.modality in ("audio", "visual")
        self.word_index = int(self.word_index)


@dataclass
class Phoneme(Event):
    phoneme_id: int


@dataclass
class MultipleWords(Event):
    words: str


@dataclass
class Motor(Event):
    """A behavioral event."""


@dataclass
class Special(Event):
    name: str


@dataclass
class Block(Event):
    uid: str

    def __post_init__(self) -> None:
        super().__post_init__()
        self.uid = str(self.uid)


CLASS_KIND_MAPPING: tp.Dict[str, tp.Type[Event]] = {
    "word": Word,
    "multiplewords": MultipleWords,
    "multiple_words": MultipleWords,
    "sound": Sound,
    "phoneme": Phoneme,
    "motor": Motor,
    "special": Special,
    "block": Block,
}

WORD_CONDITIONS = {"sentence", "context", "question", "fixation", "word_list"}
VALID_BLOCK_TYPES = {"sentence", "sound", "sentence_or_sound"}


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

def _column(values: tp.Sequence[tp.Any]) -> np.ndarray:
    """A column as pandas would type it: numbers (NaN where missing) as
    float64, or int64 when none is missing or fractional; anything else
    as object, None where missing."""
    present = [v for v in values if not _missing(v)]
    numeric = all(isinstance(v, (int, float, np.integer, np.floating))
                  and not isinstance(v, (bool, np.bool_)) for v in present)
    if numeric:
        if len(present) == len(values) and present and all(
                isinstance(v, (int, np.integer)) for v in present):
            return np.array(values, dtype=np.int64)
        return np.array([np.nan if _missing(v) else v for v in values],
                        dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = [None if _missing(v) else v for v in values]
    return out


#: the comparison operators of a query, by ``ast`` node
_COMPARE = {ast.Eq: operator.eq, ast.NotEq: operator.ne, ast.Lt: operator.lt,
            ast.LtE: operator.le, ast.Gt: operator.gt, ast.GtE: operator.ge}


class _Query:
    """A query string's subset of pandas' ``DataFrame.query`` (see
    ``EventTable.query``), evaluated over an ``EventTable``'s columns."""

    def __init__(self, table: "EventTable", condition: str) -> None:
        self.table = table
        self.condition = condition

    def refuse(self, what: str) -> NotImplementedError:
        return NotImplementedError(
            f"query {self.condition!r}: {what} is outside the subset of "
            f"pandas' query that EventTable.query takes")

    def parse(self) -> ast.expr:
        """The condition with pandas' rewrite (``&`` as ``and``, ``|`` as
        ``or``, so both bind looser than a comparison) as a Python
        expression."""
        tokens = []
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.condition).readline):
                if tok.string == "@":
                    raise self.refuse("an @ variable")
                if tok.string == "`":
                    raise self.refuse("a backtick-quoted name")
                if tok.type == tokenize.OP and tok.string in ("&", "|"):
                    tok = tok._replace(
                        type=tokenize.NAME,
                        string="and" if tok.string == "&" else "or")
                tokens.append((tok.type, tok.string))
            return ast.parse(tokenize.untokenize(tokens).strip(),
                             mode="eval").body
        except (tokenize.TokenError, SyntaxError) as error:
            raise self.refuse("this syntax") from error

    def mask(self) -> np.ndarray:
        out = self.evaluate(self.parse())
        if out[0] == "column":
            out = ("mask", self.boolean(out))
        if out[0] != "mask":
            raise self.refuse("a condition that selects no rows by a "
                              "column")
        return out[1]

    def boolean(self, operand: tuple) -> np.ndarray:
        """A column of True and False as a mask (a bare column in a
        condition)."""
        if operand[0] == "mask":
            return operand[1]
        if operand[0] == "column" and all(
                isinstance(v, (bool, np.bool_)) for v in operand[1]):
            return np.array(operand[1], dtype=bool)
        raise self.refuse("a value that is not a condition")

    def evaluate(self, node: ast.expr) -> tuple:
        """("mask", bool array), ("column", its values as a list, whether
        it holds numbers) or ("literal", a value or a list of values)."""
        if isinstance(node, ast.BoolOp):
            masks = [self.boolean(self.evaluate(v)) for v in node.values]
            combine = np.logical_and if isinstance(node.op, ast.And) \
                else np.logical_or
            return ("mask", combine.reduce(masks))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, (ast.Not, ast.Invert)):
                return ("mask", ~self.boolean(self.evaluate(node.operand)))
            if isinstance(node.op, (ast.USub, ast.UAdd)):
                kind, value = self.evaluate(node.operand)[:2]
                if kind == "literal" and isinstance(value, (int, float)) \
                        and not isinstance(value, bool):
                    return (kind, -value if isinstance(node.op, ast.USub)
                            else value)
            raise self.refuse("arithmetic")
        if isinstance(node, ast.Compare):
            mask = None
            left = self.evaluate(node.left)
            for op, right_node in zip(node.ops, node.comparators):
                right = self.evaluate(right_node)
                part = self.compare(op, left, right)
                mask = part if mask is None else mask & part
                left = right
            return ("mask", mask)
        if isinstance(node, ast.Name):
            if node.id not in self.table._columns:
                raise KeyError(f"query {self.condition!r}: no column "
                               f"{node.id!r}")
            column = self.table._columns[node.id]
            return ("column", column.tolist(), column.dtype != object)
        if isinstance(node, ast.Constant):
            value = node.value
            if value is None or isinstance(value, (bool, int, float, str)):
                return ("literal", value)
            raise self.refuse(f"the literal {value!r}")
        if isinstance(node, (ast.List, ast.Tuple)):
            values = [self.evaluate(v) for v in node.elts]
            if any(v[0] != "literal" or isinstance(v[1], list)
                   for v in values):
                raise self.refuse("a list of anything but literals")
            return ("literal", [v[1] for v in values])
        if isinstance(node, ast.Attribute):
            raise self.refuse("attribute access")
        if isinstance(node, ast.Call):
            raise self.refuse("a call")
        if isinstance(node, ast.BinOp):
            raise self.refuse("arithmetic")
        raise self.refuse(f"{type(node).__name__}")

    def compare(self, op: ast.cmpop, left: tuple, right: tuple
                ) -> np.ndarray:
        """One comparison as pandas makes it: a missing value (None or
        NaN) fails ``==`` and the order comparisons and passes ``!=``;
        ``in`` (and ``==`` with a list) is pandas' ``isin``, where a None
        in the list matches a missing value of a text column only."""
        is_list = right[0] == "literal" and isinstance(right[1], list)
        if isinstance(op, (ast.In, ast.NotIn)) or (
                is_list and isinstance(op, (ast.Eq, ast.NotEq))):
            if left[0] != "column" or not is_list:
                raise self.refuse("a membership test other than a column "
                                  "in a list")
            found = self.isin(left[1], right[1], numeric=left[2])
            return ~found if isinstance(op, (ast.NotIn, ast.NotEq)) \
                else found
        if type(op) not in _COMPARE:
            raise self.refuse(f"the operator {type(op).__name__}")
        if "column" not in (left[0], right[0]):
            raise self.refuse("a comparison that reads no column")
        if "mask" in (left[0], right[0]) or is_list or (
                left[0] == "literal" and isinstance(left[1], list)):
            raise self.refuse("a comparison of a condition or a list")
        fn = _COMPARE[type(op)]
        n = self.table._length
        a = left[1] if left[0] == "column" else [left[1]] * n
        b = right[1] if right[0] == "column" else [right[1]] * n
        missing_result = isinstance(op, ast.NotEq)
        return np.array([missing_result if _missing(x) or _missing(y)
                         else bool(fn(x, y)) for x, y in zip(a, b)],
                        dtype=bool)

    @staticmethod
    def isin(values: tp.List[tp.Any], wanted: tp.List[tp.Any],
             numeric: bool) -> np.ndarray:
        """Which of a column's `values` are in `wanted` (`numeric`: a
        column of numbers, whose NaN no None matches)."""
        present = [v for v in wanted if not _missing(v)]
        null = any(_missing(v) for v in wanted) and not numeric
        return np.array([null if _missing(v) else v in present
                         for v in values], dtype=bool)


class EventTable:
    """Events as numpy columns of equal length, in insertion order."""

    def __init__(self, columns: tp.Mapping[str, np.ndarray]) -> None:
        self._columns = dict(columns)
        lengths = {len(c) for c in self._columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {lengths}")
        self._length = lengths.pop() if lengths else 0

    @classmethod
    def from_records(cls, records: tp.Sequence[tp.Mapping[str, tp.Any]]
                     ) -> "EventTable":
        """A table of dicts, as ``pd.DataFrame(records)``: the columns in
        the order they first appear, missing values where a dict lacks
        one."""
        names: tp.Dict[str, None] = {}
        for record in records:
            names.update(dict.fromkeys(record))
        return cls({name: _column([r.get(name) for r in records])
                    for name in names})

    @staticmethod
    def concat(tables: tp.Sequence["EventTable"]) -> "EventTable":
        """Rows of each table in turn, as ``pd.concat``."""
        return EventTable.from_records(
            [row for table in tables for row in table.records()])

    def __len__(self) -> int:
        return self._length

    @property
    def columns(self) -> tp.List[str]:
        return list(self._columns)

    @property
    def empty(self) -> bool:
        return self._length == 0

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, key: tp.Any) -> tp.Any:
        """A column by name, or the rows a boolean mask or an index array
        selects, as a new table."""
        if isinstance(key, str):
            return self._columns[key]
        return EventTable({name: col[key]
                           for name, col in self._columns.items()})

    def get(self, name: str, default: tp.Any = None) -> tp.Any:
        return self._columns.get(name, default)

    def copy(self) -> "EventTable":
        return EventTable({k: v.copy() for k, v in self._columns.items()})

    def assign(self, **columns: tp.Any) -> "EventTable":
        """A new table with the given columns added or replaced (a scalar
        fills the column)."""
        out = dict(self._columns)
        for name, values in columns.items():
            if np.ndim(values) == 0:
                values = [values] * self._length
            out[name] = _column(list(values))
        return EventTable(out)

    def records(self) -> tp.List[tp.Dict[str, tp.Any]]:
        """The rows as dicts (numbers as python floats and ints)."""
        cols = [(name, col.tolist()) for name, col in self._columns.items()]
        return [{name: values[i] for name, values in cols}
                for i in range(self._length)]

    def kind_mask(self, *kinds: str) -> np.ndarray:
        return np.isin(self._columns["kind"].astype(str), kinds)

    def sort_by_start(self) -> "EventTable":
        """Rows by start, in the order of pandas' ``sort_values("start")``
        (numpy's unstable quicksort argsort of the non-NaN starts, NaN
        last)."""
        start = np.asarray(self._columns["start"], dtype=np.float64)
        nan = np.isnan(start)
        index = np.arange(len(start))
        order = index[~nan][start[~nan].argsort(kind="quicksort")]
        return self[np.concatenate([order, index[nan]])]

    def query(self, condition: str) -> "EventTable":
        """The rows where `condition` holds: the subset of pandas'
        ``DataFrame.query`` (python engine) that a config string holds,
        with the same rows.

        - Operands: column names (bare, no backticks) and literals: str,
          int, float, True, False, None, and lists or tuples of them.
        - Comparisons: ``==``, ``!=``, ``<``, ``<=``, ``>``, ``>=``,
          chained (``0 < start < 5`` is both), ``in`` and ``not in`` a
          list (``==`` and ``!=`` with a list too, as in pandas).
        - Logic: ``and``, ``or``, ``not``, ``&``, ``|``, ``~`` and
          parentheses. As pandas does, ``&`` and ``|`` are read as ``and``
          and ``or``, so they bind looser than a comparison
          (``kind=='word' & word_index==0``).
        - Missing values (NaN, None) fail ``==`` and the order comparisons
          and pass ``!=``; ``in`` is pandas' ``isin``, where a None in the
          list matches the missing values of a text column and never a
          missing number.

        Anything else raises NotImplementedError naming the query:
        attribute access, calls, ``@`` variables, arithmetic (a literal's
        sign aside), a comparison that reads no column. A name that is no
        column raises KeyError."""
        return self[_Query(self, condition).mask()]

    # -- typed events ---------------------------------------------------------

    def validate(self) -> "EventTable":
        """Each row merged with its event class's normalized fields (the
        class's checks run on every row), as the JAX package's
        ``.event.validate()``."""
        if self.empty:
            return self.copy()
        out = []
        for row in self.records():
            kind = row["kind"]
            if kind not in CLASS_KIND_MAPPING:
                raise ValueError(
                    f'Unexpected kind "{kind}". Add a new Event class in '
                    "brainmagick_tpu_torch.events to support it.")
            out.append({**row, **asdict(CLASS_KIND_MAPPING[kind].from_dict(
                row))})
        return EventTable.from_records(out)

    def iter(self) -> tp.Iterator[Event]:
        """The validated rows as typed events."""
        for row in self.validate().records():
            yield CLASS_KIND_MAPPING[row["kind"]].from_dict(row)

    def create_blocks(self, groupby: str) -> "EventTable":
        """``create_blocks`` of this table's validated rows."""
        return create_blocks(self.validate(), groupby=groupby)

    def merge_blocks(self, min_block_duration_s: float = 60
                     ) -> "EventTable":
        """``merge_blocks`` of this table's validated block rows."""
        blocks = self.validate()
        return merge_blocks(blocks[blocks.kind_mask("block")],
                            min_block_duration_s=min_block_duration_s)


# ---------------------------------------------------------------------------
# Sequence info
# ---------------------------------------------------------------------------

def extract_sequence_info(events: EventTable, word: bool = True,
                          phoneme: bool = True) -> EventTable:
    """Fill the word_index, word_sequence and phoneme_id columns from
    sequence_id, where they are missing."""
    def is_missing(rows: tp.List[dict], key: str) -> bool:
        return all(_missing(r.get(key)) for r in rows)

    records = events.records()
    kinds = [r["kind"] for r in records]

    def groups(names: tp.Tuple[str, ...], select: tp.Sequence[int]):
        """Row indices by key, rows with a missing key left out (as
        pandas' groupby does)."""
        out: tp.Dict[tp.Any, tp.List[int]] = {}
        for i in select:
            key = tuple(records[i].get(name) for name in names)
            if not any(_missing(k) for k in key):
                out.setdefault(key, []).append(i)
        return list(out.values())

    if word and "word" in kinds:
        missing = [c for c in ("sequence_id", "word") if c not in events]
        if missing:
            raise ValueError(
                f'Columns "{missing}" are required but were not found.')
        is_word = [i for i, k in enumerate(kinds)
                   if k in ("word", "multiplewords")]
        if len({records[i]["sequence_id"] for i in is_word}) < 2:
            raise ValueError("Only one word sequence ID found.")
        # the groups as the input has them, before any fill
        original = events.records()
        for group in groups(("sequence_id",), is_word):
            rows = [original[i] for i in group]
            if is_missing(rows, "word_index"):
                counts = np.cumsum([0] + [len(str(r["word"]).split())
                                          for r in rows])
                for i, index in zip(group, counts[:-1]):
                    records[i]["word_index"] = int(index)
            if is_missing(rows, "word_sequence"):
                sequence = " ".join(str(r["word"]) for r in rows)
                for i in group:
                    records[i]["word_sequence"] = sequence

    if phoneme and "phoneme" in kinds:
        select = [i for i, k in enumerate(kinds) if k == "phoneme"]
        if is_missing([records[i] for i in select], "word_index"):
            raise ValueError(
                'Column "word_index" is required but was not found.')
        for group in groups(("sequence_id", "word_index"), select):
            if is_missing([records[i] for i in group], "phoneme_id"):
                for position, i in enumerate(group):
                    records[i]["phoneme_id"] = position
    return EventTable.from_records(records)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _unique(values: np.ndarray) -> tp.List[tp.Any]:
    """The distinct values in order of appearance, every missing one as
    a single NaN (pandas' ``Series.unique``)."""
    out: tp.List[tp.Any] = []
    seen: tp.Set[tp.Any] = set()
    missing = False
    for value in values.tolist():
        if _missing(value):
            if not missing:
                missing = True
                out.append(float("nan"))
        elif value not in seen:
            seen.add(value)
            out.append(value)
    return out


def _get_block_uid(events: EventTable) -> tp.Any:
    """The uid of a block from the events it holds: their one
    sequence_uid, else their words (phonemes aside), else their sound
    files and first start."""
    if "sequence_uid" in events:
        unique = _unique(events["sequence_uid"])
        if len(unique) == 1:
            return unique[0]
    condition = events["condition"].tolist()
    kinds = events["kind"].tolist()
    has_words = [c in WORD_CONDITIONS and k != "phoneme"
                 for c, k in zip(condition, kinds)]
    if not any(has_words):
        files = events["filepath"] if "filepath" in events \
            else np.full(len(events), np.nan)
        parts = [f for f in _unique(files) if isinstance(f, str)]
        assert parts, \
            "No filepath information available for defining block unique ID."
        parts = parts + [str(np.nanmin(events["start"].astype(np.float64)))]
    else:
        words = events["word"].tolist()
        parts = ["nan" if _missing(w) else str(w)
                 for w, keep in zip(words, has_words) if keep]
    return " ".join(parts)


def create_blocks(events: EventTable, groupby: str) -> EventTable:
    """The events with a ``block`` row at each block start: the first word
    of each sentence (``sentence``), each sound (``sound``), or either, a
    sentence then starting at its first visual word
    (``sentence_or_sound``). A block runs to the next block's start (the
    last to infinity); its uid comes from the events it holds
    (``_get_block_uid``). Rows in pandas' order: each block just before
    the events that share its start."""
    assert groupby in VALID_BLOCK_TYPES, \
        f"by={groupby} not supported, must be one of {VALID_BLOCK_TYPES}."
    n = len(events)
    kinds = np.array([str(k) for k in events["kind"].tolist()], dtype=object)
    word_index = events.get("word_index")
    if groupby == "sentence":
        index = np.full(n, -1) if word_index is None else word_index
        start_mask = (kinds == "word") & (index == 0)
    elif groupby == "sound":
        start_mask = kinds == "sound"
    else:
        word_starts = kinds == "word"
        if word_index is not None and "modality" in events:
            word_starts &= events["modality"] == "visual"
            word_starts &= word_index == 0
        else:
            word_starts[:] = False
        start_mask = (kinds == "sound") | word_starts
    start_mask = np.asarray(start_mask, dtype=bool)

    eps = 1e-7
    starts = events["start"].astype(np.float64)
    stops = starts + events["duration"].astype(np.float64)
    events_end = np.nanmax(stops) + eps
    block_rows = events[start_mask].records()
    block_starts = starts[start_mask]
    assert (np.diff(block_starts) > 0).all(), "events not sorted"
    block_stops = np.concatenate([block_starts[1:], [events_end]])
    block_events = []
    for row, stop in zip(block_rows, block_stops):
        mask = (starts >= row["start"]) & (stops < stop)
        info = asdict(Block(start=row["start"], duration=stop - row["start"],
                            uid=_get_block_uid(events[mask]),
                            language=row.get("language"),
                            modality=row.get("modality")))
        block_events.append({**info, "kind": "block"})
    # the last block runs to the end of the recording
    block_events[-1]["duration"] = float("inf")

    out = EventTable.from_records(events.records() + block_events)
    is_block = np.zeros(len(out), dtype=bool)
    is_block[n:] = True
    # each block is sorted before the events that share its start
    start = out["start"].astype(np.float64).copy()
    start[is_block] -= eps
    out = out.assign(start=start).sort_by_start()
    start = out["start"].astype(np.float64).copy()
    start[out.kind_mask("block")] += eps
    return out.assign(start=start)


def merge_blocks(blocks: EventTable, min_block_duration_s: float = 60
                 ) -> EventTable:
    """Merge consecutive blocks until each lasts at least
    `min_block_duration_s` (the last one may stay shorter)."""
    new_blocks: tp.List[dict] = []
    uids: tp.List[str] = []
    start = 0.0
    rows = blocks.records()
    for k, row in enumerate(rows):
        uids.append(str(row["uid"]))
        stop = row["start"] + row["duration"]
        if k == len(rows) - 1 or stop > start + min_block_duration_s:
            info = asdict(Block(start=start, duration=stop - start,
                                uid=",".join(uids),
                                language=row.get("language"),
                                modality=row.get("modality")))
            new_blocks.append({**info, "kind": "block"})
            uids, start = [], stop
    assert not uids, "All blocks should have been included"
    out = EventTable.from_records(new_blocks)
    if (out["duration"][:-1] < min_block_duration_s).any():
        raise ValueError(
            f"Some blocks are smaller than {min_block_duration_s}.")
    return out


def assign_blocks(blocks: EventTable, ratios: tp.List[float], seed: int,
                  remove_ratio: float = 0.,
                  min_n_blocks_per_split: int = 20) -> EventTable:
    """Assign each block to one of len(ratios) + 1 splits: sha256(uid) +
    seed seeds a ``random.Random`` whose first draw picks the split from
    the ratios' CDF, so a block lands in the same split in every run and
    for every subject."""
    ratios = list(ratios)
    if remove_ratio > 0.:
        ratios = ratios + [remove_ratio]
    assert all(r > 0 for r in ratios)
    assert sum(ratios) < 1., "last dataset has negative ratio size"
    ratios.append(1. - sum(ratios))
    cdf = np.cumsum(ratios)

    split = []
    for uid in blocks["uid"].tolist():
        hashed = int(hashlib.sha256(str(uid).encode()).hexdigest(), 16)
        score = random.Random(hashed + seed).random()
        split.append(int(np.searchsorted(cdf, score, side="right")))
    out = blocks.assign(split=split)
    counts = np.bincount(np.asarray(split, dtype=np.int64))
    if (counts[counts > 0] < min_n_blocks_per_split).any():
        raise ValueError(f"At least one of the splits has fewer than "
                         f"{min_n_blocks_per_split} blocks.")
    if remove_ratio > 0.:
        removed = len(ratios) - 2
        out = out[out["split"] != removed]
        out = out.assign(split=[s - 1 if s > removed else s
                                for s in out["split"].tolist()])
    return out


def split_wav_as_block(events: EventTable,
                       blocks: tp.List[tp.Tuple[float, float]],
                       margin: float = 0.1) -> EventTable:
    """Cut sound events at the block boundaries that fall inside them (more
    than `margin` from their edges), advancing each piece's `offset` so
    that its audio stays aligned."""
    if "offset" not in events:
        events = events.assign(offset=0.)
    sound = events.kind_mask("sound")

    # a block start may cut a piece that begins exactly `margin` before
    # it; a block stop needs a strictly larger gap
    boundaries: tp.List[tp.Tuple[float, bool]] = sorted(
        {(float(b[0]), True) for b in blocks}
        | {(float(b[1]), False) for b in blocks})

    def cut_points(e_start: float, e_stop: float) -> tp.List[float]:
        cuts: tp.List[float] = []
        cursor = e_start
        for point, is_block_start in boundaries:
            if e_stop <= point + margin:
                break
            inside = (cursor <= point - margin if is_block_start
                      else cursor < point - margin)
            if inside and point != cursor:
                cuts.append(point)
                cursor = point
        return cuts

    pieces = []
    for event in events[sound].records():
        e_start = float(event["start"])
        e_stop = e_start + float(event["duration"])
        edges = [e_start] + cut_points(e_start, e_stop) + [e_stop]
        for lo, hi in zip(edges[:-1], edges[1:]):
            pieces.append({**event, "start": lo, "duration": hi - lo,
                           "offset": event["offset"] + (lo - e_start)})
    others = events[~sound].records()
    return EventTable.from_records(pieces + others).sort_by_start()
