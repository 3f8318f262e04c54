"""The schoffelen2019 MEG study (MOUS: 273-channel CTF at 1200 Hz, 96
audio and 99 visual Dutch subjects).

Port of ``brainmagick_tpu/studies/schoffelen2019.py``, without pandas.
The Presentation log goes through the same pipeline, step for step:

  1. parse the log (two tab-separated blocks joined on their
     Picture/Sound/Nothing rows, times in 1e-4 s);
  2. relabel the conditions (ZINNEN -> sentence, WOORDEN -> word_list,
     FIX -> fix, ...), mark each trial's context and block, take the
     words from the codes;
  3. audio: the wav of each "Start File" row, and each audio onset
     expanded into the word and phoneme tiers of its TextGrid;
  4. each fixation-delimited trial's word_sequence and word_index, and
     the sentence uid of stimuli.txt (a 45-character prefix lookup);
  5. the log's clock mapped onto the MEG's by Levenshtein matching of
     the fixation and context rows with the stim channel's triggers (fix
     20, context 10), checked by a Spearman r > 0.9999;
  6. the word, phoneme and sound rows, with sentence_or_sound blocks.

pandas labels each row and keeps the labels through a sort; a label
slice then runs between the two labels' positions. ``_Log`` keeps the
labels and slices so, and NaN where a cell is missing, so that every
step assigns the rows pandas assigns. The raw is a CTF ``.ds`` (the
release), a FIF conversion or an ``.npz`` test stand-in.
"""

from __future__ import annotations

import itertools
import logging
import math
import re
import typing as tp
from pathlib import Path

import numpy as np

from ..events import EventTable
from ..phonemes import ph_dict
from ..textgrid import read_textgrid
from . import api, utils
from .io import FIFFV_MEG_CH, FIFFV_STIM_CH, find_events, read_fif
from .utils import match_list

logger = logging.getLogger(__name__)

RAW_SAMPLE_RATE = 1200


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------

class StudyPaths:
    """A subject's files in the Donders layout."""

    TEST_FILENAMES = ("testmeg-raw.npz", "testmeg-raw.fif")

    def __init__(self, subject_uid: str) -> None:
        self._subject_uid = subject_uid

    @staticmethod
    def dataset() -> Path:
        return utils.StudyPaths("schoffelen2019").download

    @property
    def raw(self) -> Path:
        """A test stand-in, else the last FIF conversion, else the last
        CTF ``.ds`` (rest recordings aside)."""
        meg_folder = self.dataset() / self._subject_uid / "meg"
        for name in self.TEST_FILENAMES:
            test_file = meg_folder / name
            if test_file.exists():
                return test_file
        fif_files = [p for p in meg_folder.glob("*.fif")
                     if "rest" not in p.name]
        if fif_files:
            return sorted(fif_files)[-1]
        meg_files = [p for p in meg_folder.glob("*.ds")
                     if "rest" not in p.name]
        if not meg_files:
            raise RuntimeError(f"No MEG file for {self._subject_uid} "
                               f"in {meg_folder}")
        return sorted(meg_files)[-1]

    @property
    def metadata(self) -> Path:
        folder = self.dataset() / "sourcedata" / "meg_task"
        logs = sorted(folder.glob(f"*{self._subject_uid[4:]}*.log"))
        if not logs:
            raise RuntimeError(f"No Presentation log for "
                               f"{self._subject_uid} in {folder}")
        return logs[-1]

    @staticmethod
    def wave_file(name: str) -> Path:
        return StudyPaths.dataset() / "stimuli" / "audio_files" / name

    @staticmethod
    def phoneme_file(sequence_id: int) -> Path:
        return (StudyPaths.dataset() / "derivatives" / "textgrids"
                / ("EQ_Ramp_Int2_Int1LPF%.3i.TextGrid" % sequence_id))

    @staticmethod
    def stimuli_file() -> Path:
        return StudyPaths.dataset() / "stimuli" / "stimuli.txt"


# ---------------------------------------------------------------------------
# The log as a labelled table
# ---------------------------------------------------------------------------

NAN = math.nan


def _isna(value: tp.Any) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


class _Log:
    """Named columns of python values (NaN where missing) over row labels,
    with the row selections pandas' ``.loc`` makes."""

    def __init__(self, columns: tp.Dict[str, tp.List[tp.Any]],
                 index: tp.List[int]) -> None:
        self.columns = columns
        self.index = index
        self._positions: tp.Optional[tp.Dict[int, int]] = None

    @classmethod
    def from_records(cls, records: tp.Sequence[tp.Mapping[str, tp.Any]],
                     index: tp.Optional[tp.List[int]] = None) -> "_Log":
        names: tp.Dict[str, None] = {}
        for record in records:
            names.update(dict.fromkeys(record))
        return cls({name: [r.get(name, NAN) for r in records]
                    for name in names},
                   list(range(len(records))) if index is None else index)

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> tp.List[tp.Any]:
        return self.columns[name]

    def row(self, position: int) -> tp.Dict[str, tp.Any]:
        return {name: col[position] for name, col in self.columns.items()}

    def where(self, mask: tp.Iterable[bool]) -> tp.List[int]:
        return [k for k, m in enumerate(mask) if m]

    def set(self, name: str, positions: tp.Iterable[int],
            values: tp.Any) -> None:
        """``.loc[rows, name] = values`` (a scalar or one value per row);
        a new column is NaN elsewhere."""
        positions = list(positions)
        if name not in self.columns:
            self.columns[name] = [NAN] * len(self)
        column = self.columns[name]
        if isinstance(values, (list, tuple, np.ndarray)):
            assert len(values) == len(positions)
            for k, value in zip(positions, values):
                column[k] = value
        else:
            for k in positions:
                column[k] = values

    def position(self, label: int) -> int:
        if self._positions is None:
            self._positions = {lab: k for k, lab in enumerate(self.index)}
        return self._positions[label]

    def span(self, first: tp.Optional[int], last: tp.Optional[int] = None
             ) -> range:
        """The positions of the label slice ``first:last`` (both ends
        included, None open): from the position of `first` to that of
        `last`. A label past the last one of an increasing index gives an
        empty span; on any other index it raises, as pandas does."""
        def bound(label, default):
            if label is None:
                return default
            try:
                return self.position(label)
            except KeyError:
                if label > self.index[-1] and all(
                        a < b for a, b in zip(self.index, self.index[1:])):
                    return len(self)
                raise
        lo = bound(first, 0)
        hi = len(self) - 1 if last is None else bound(last, len(self))
        return range(lo, hi + 1)

    def take(self, positions: tp.Sequence[int]) -> "_Log":
        return _Log({name: [col[k] for k in positions]
                     for name, col in self.columns.items()},
                    [self.index[k] for k in positions])

    def rename(self, mapping: tp.Mapping[str, str]) -> None:
        self.columns = {mapping.get(name, name): col
                        for name, col in self.columns.items()}


def _sort_order(values: tp.Sequence[float]) -> np.ndarray:
    """The row order of pandas' ``sort_values``: numpy's (unstable)
    quicksort argsort of the non-NaN values, NaN last."""
    values = np.asarray(values, dtype=np.float64)
    nan = np.isnan(values)
    index = np.arange(len(values))
    order = index[~nan][values[~nan].argsort(kind="quicksort")]
    return np.concatenate([order, index[nan]])


# ---------------------------------------------------------------------------
# Presentation-log parsing
# ---------------------------------------------------------------------------

def _seconds_if_time(key: str, val: str) -> tp.Any:
    """Presentation logs times are integers in 1e-4 s units."""
    if val.isnumeric() and any(z in key.lower() for z in ("time", "dur")):
        return float(val) / 1e4
    return val


def _process_log_block(block: str) -> tp.List[tp.Dict[str, tp.Any]]:
    """The rows of one tab-separated block; its header holds
    'Uncertainty' twice (of the time and of the duration)."""
    lines = block.split("\n")
    iterlines = enumerate(lines)
    ind, line = next(iterlines)
    while "Uncertainty" not in line:
        ind, line = next(iterlines)
    headers = [x.replace(" ", "_") for x in line.split("\t")]
    replacements = iter(["time_uncertainty", "duration_uncertainty"])
    for k, name in enumerate(headers):
        if name == "Uncertainty":
            headers[k] = next(replacements)
    data = []
    for line in lines[ind + 1:]:
        if not line:
            continue
        row = dict(zip(headers, line.split("\t")))
        data.append({k: _seconds_if_time(k, v) for k, v in row.items()})
    return data


def parse_log(log_fname: tp.Union[str, Path]) -> _Log:
    """The log's two blocks, the second's rows beside the first's
    Picture/Sound/Nothing rows."""
    text = Path(log_fname).read_text()
    text = text.replace(".\n", ".")  # broken line wraps
    text = text.split("Scenario -")[1]  # drop duplicated prefix logs
    data1, data2 = [_process_log_block(b) for b in text.split("\n\n\n")]
    log = _Log.from_records(data1)
    common = ("Picture", "Sound", "Nothing")
    index = log.where(t in common for t in log["Event_Type"])
    extra = _Log.from_records(data2, index=index)
    for key in sorted(set(log.columns) & set(extra.columns)):
        assert all(log[key][i] == ("" if _isna(v) else v)
                   for i, v in zip(index, extra[key]))
        del extra.columns[key]
    for name, values in extra.columns.items():
        log.set(name, index, values)
    return log


_CONDITION_CODES = dict(ZINNEN="sentence", WOORDEN="word_list", FIX="fix",
                        QUESTION="question", Response="response",
                        ISI="isi", blank="blank")


def clean_log(log: _Log) -> _Log:
    """Condition labels, each trial's context and block, the words."""
    codes = log["Code"]
    for key, value in _CONDITION_CODES.items():
        log.set("condition", log.where(
            isinstance(c, str) and re.search(key, c) is not None
            for c in codes), value)
    log.set("condition", log.where(c == "" for c in codes), "blank")

    # each trial's context (sentence or word_list) and block
    start, block, context = 0, 0, "init"
    log.set("new_context", range(len(log)), False)
    trials = [(k, c) for k, c in enumerate(log["condition"])
              if c in ("word_list", "sentence")]
    for idx, condition in trials:
        log.set("context", log.span(start, idx), context)
        log.set("block", log.span(start, idx), block)
        log.set("new_context", [idx], True)
        context = condition
        block += 1
        start = idx
    log.set("context", log.span(start), context)
    log.set("block", log.span(start), block)

    log.set("Time", range(len(log)),
            [0.0 if not isinstance(x, (int, float)) else x
             for x in log["Time"]])
    condition = log["condition"]
    log.set("condition", log.where(_isna(c) for c in condition), "word")
    is_word = [c == "word" for c in condition]
    words = [NAN if _isna(c) else str(c).strip("0123456789 ")
             for c in codes]
    log.set("word", log.where(is_word), [w for w, m in zip(words, is_word)
                                         if m])
    word = log["word"]
    log.set("word", log.where(w == "" and c == "word"
                              for w, c in zip(word, condition)), NAN)
    log.set("condition", log.where(_isna(w) and c == "word"
                                   for w, c in zip(word, condition)),
            "blank")
    log.set("condition", log.where(c == "pause" for c in codes), "pause")
    log.rename({name: name.lower() for name in log.columns})
    log.set("condition", log.where(w == "PULSE MODE" for w in log["word"]),
            "pulse")
    return log


def add_sound_events(log: _Log) -> _Log:
    """Each Sound row's wav; the row after it (the audio onset) becomes
    the sound event."""
    onset = log.where(t == "Sound" for t in log["event_type"])
    log.set("filepath", onset, [
        str(StudyPaths.wave_file(log["code"][k].split("Start File ")[1]))
        for k in onset])
    after = [log.position(log.index[k] + 1) for k in onset]
    log.set("filepath", after, [log["filepath"][k] for k in onset])
    log.set("condition", onset, "sound_legacy")
    log.set("condition", after, "sound")
    return log


def tgrid_to_dict(fname: tp.Union[str, Path]
                  ) -> tp.List[tp.Dict[str, tp.Any]]:
    """A TextGrid's word (ORT-MAU) and phoneme (MAU) rows by start, each
    phoneme with its word."""
    parts: tp.Dict[str, tp.List] = {}
    for p in read_textgrid(fname):
        if p.name not in ("", "<p:>"):
            parts.setdefault(p.tier, []).append(p)
    words = parts["ORT-MAU"]
    phonemes = parts["MAU"]
    rows: tp.List[tp.Dict[str, tp.Any]] = []
    for word_index, word in enumerate(words):
        rows.append(dict(event_type="word", start=word.start, stop=word.stop,
                         word_index=word_index, word=word.name,
                         modality="audio"))
    starts = np.array([r["start"] for r in rows])
    for phoneme in phonemes:
        assert phoneme.name in ph_dict, \
            f"{phoneme.name} not in phoneme inventory"
        idx = np.where(phoneme.start < starts)[0]
        idx = idx[0] - 1 if idx.size else len(rows) - 1
        row = rows[idx]
        rows.append(dict(event_type="phoneme", start=phoneme.start + 1e-6,
                         stop=phoneme.stop, word_index=row["word_index"],
                         word=row["word"], phoneme=phoneme.name,
                         phoneme_id=ph_dict[phoneme.name],
                         modality="audio"))
    rows.sort(key=lambda r: float(r["start"]))
    return rows


def add_phonemes(log: _Log, phonemes_path: tp.Optional[Path] = None
                 ) -> _Log:
    """Each audio onset expanded into its TextGrid's words and phonemes,
    then the rows sorted by time."""
    if phonemes_path is None:
        phonemes_path = StudyPaths.phoneme_file(0).parent

    # each audio file's id over its rows
    log.set("sequence_id", range(len(log)), NAN)
    file_: tp.Any = NAN
    prev_start = prev_stop = 0
    word = log["word"]
    starts = [k for k, w in enumerate(word) if "Start File" in _text(w)]
    stops = [k for k, w in enumerate(word) if "End of file" in _text(w)]
    assert len(starts) == len(stops)
    for start, stop in zip(starts, stops):
        log.set("sequence_id", log.span(prev_start, prev_stop), file_)
        # a float, as in pandas' column
        file_ = float(int(_text(word[log.position(start)]).split()[-1][:-4]))
        prev_start, prev_stop = start, stop
    log.set("sequence_id", log.span(prev_start, prev_stop), file_)

    rows: tp.List[tp.Dict[str, tp.Any]] = []
    for start in [k for k, w in enumerate(log["word"])
                  if w == "Audio onset"]:
        row = log.row(log.position(start))
        if row["condition"] != "sound":
            raise RuntimeError(f"Unexpected condition {row['condition']}")
        fname = (Path(phonemes_path) / ("EQ_Ramp_Int2_Int1LPF%.3i.TextGrid"
                                        % row["sequence_id"]))
        content = tgrid_to_dict(fname)
        for d in content:
            d.update(subject=row.get("subject"), trial=row.get("trial"),
                     stim_type="sound", context=row["context"],
                     block=row["block"], sequence_id=row["sequence_id"],
                     duration=d["stop"] - d["start"],
                     filepath=row["filepath"],
                     time=row["time"] + d["start"])
        position = log.position(start)
        log.set("start", [position], 0)
        duration = content[-1]["stop"]
        log.set("stop", [position], duration)
        log.set("duration", [position], duration)
        rows.extend(content)
    log = _concat(log, _Log.from_records(rows))
    for condition in ("word", "phoneme"):
        log.set("condition", log.where(t == condition
                                       for t in log["event_type"]),
                condition)
    log.set("condition", log.where(w == "End of file" for w in log["word"]),
            "end")
    log.set("condition", log.where(
        t == "Nothing" and c == "word"
        for t, c in zip(log["event_type"], log["condition"])), "nothing")
    return log.take(_sort_order(log["time"]).tolist())


def _text(value: tp.Any) -> str:
    """``str(value)``, NaN as pandas' 'nan'."""
    return "nan" if _isna(value) else str(value)


def _concat(first: _Log, second: _Log) -> _Log:
    """The rows of both, relabelled 0..n-1 (``pd.concat(...,
    ignore_index=True)``): the first's columns, then the second's new
    ones."""
    names = list(first.columns) + [n for n in second.columns
                                   if n not in first.columns]
    return _Log({name: first.columns.get(name, [NAN] * len(first))
                 + second.columns.get(name, [NAN] * len(second))
                 for name in names},
                list(range(len(first) + len(second))))


def add_word_sequence_and_position(log: _Log) -> _Log:
    """Each fixation-delimited trial's word_sequence and word_index."""
    fixes = [log.index[k] for k, c in enumerate(log["condition"])
             if c == "fix"]
    for ind1, ind2 in zip(fixes, fixes[1:] + [log.index[-1]]):
        span = log.span(ind1, ind2)
        is_word = [log["condition"][k] == "word" for k in span]
        sequence = " ".join(str(log["word"][k])
                            for k, w in zip(span, is_word) if w)
        if sequence:
            log.set("word_sequence", span, sequence)
            log.set("word_index", span, [
                int(i) for i in np.maximum(0, np.cumsum(is_word) - 1)])
    return log


def add_sequence_uid(log: _Log) -> _Log:
    """Each row's sentence uid from stimuli.txt, by the first 45
    characters of its word_sequence (some trials miss their last word);
    the rows before the first sentence take its uid."""
    max_char = 45
    sequence_uids: tp.Dict[str, int] = {}
    with open(StudyPaths.stimuli_file()) as f:
        for line in f.readlines():
            idx = line.find(" ")
            uid = int(line[:idx])
            sequence = line[idx + 1:].replace("\n", "")[:max_char].lower()
            assert sequence not in sequence_uids
            assert uid != 0, "uid should not be 0"
            sequence_uids[sequence] = uid

    def _map(sequence: tp.Any) -> tp.Optional[int]:
        if not isinstance(sequence, str):
            return None
        key = sequence[:max_char].lower()
        assert key in sequence_uids, key
        return sequence_uids[key]

    uids: tp.List[tp.Any] = [_map(s) for s in log["word_sequence"]]
    if any(u is None for u in uids):
        # a missing uid makes pandas' column float
        uids = [NAN if u is None else float(u) for u in uids]
    missing = [_isna(u) for u in uids]
    first_idx = missing.index(False) if False in missing else 0
    assert not any(missing[first_idx:]), "NaNs should be only at start"
    uids[:first_idx] = [uids[first_idx]] * first_idx
    log.set("sequence_uid", range(len(log)), uids)
    return log


def read_log(log_fname: tp.Union[str, Path]) -> _Log:
    """The whole log pipeline, up to the sentence uids."""
    log = clean_log(parse_log(log_fname))
    name = str(log_fname)
    if "MEG-MOUS-Aud" in name:
        log = add_phonemes(add_sound_events(log))
    elif "MEG-MOUS-Vis" in name:
        log.set("modality", log.where(c == "word"
                                      for c in log["condition"]), "visual")
    else:
        raise ValueError(f"Unknown log type: {log_fname}")
    log = add_sequence_uid(add_word_sequence_and_position(log))
    assert len(log)
    return log


def get_log_times(log: _Log, events: np.ndarray, sfreq: float) -> _Log:
    """The log's rows on the MEG clock (``meg_time``, ``meg_sample``):
    the fixation and context rows matched with the triggers (fix 20,
    context 10, the fixations compared), each matched row at its
    trigger's time and the rows between two matches shifted with the
    first of them. Rows outside the recording are dropped.

    events: [N, 3] (sample, previous value, trigger code)."""
    from scipy.stats import spearmanr

    last_sample = events[-1, 0]
    sel = np.sort(np.r_[np.where(events[:, 2] == 20)[0],
                        np.where(events[:, 2] == 10)[0]])
    common_megs = events[sel]
    common_logs = log.where(
        n is True or c == "fix"
        for n, c in zip(log["new_context"], log["condition"]))
    fix_logs = [isinstance(log["code"][k], str) and "FIX" in log["code"][k]
                for k in common_logs]
    fix_megs = common_megs[:, 2] == 20
    if len(fix_megs) < 40 or len(fix_logs) < 40:
        logger.warning("match_list may be based on too few elements")
    assert len(fix_megs) > 1 and len(fix_logs) > 1
    idx_logs, idx_megs = match_list(fix_logs, fix_megs.tolist())

    time = log["time"]
    common_logs = [common_logs[k] for k in idx_logs.tolist()]
    time_meg = common_megs[idx_megs, 0] / sfreq
    r, _ = spearmanr([time[k] for k in common_logs], time_meg)
    assert r > 0.9999, f"log/MEG trigger correlation too low: {r}"
    common_megs = common_megs[idx_megs]

    last_log = time[common_logs[0]]
    last_meg = common_megs[0, 0]
    last_idx = 0
    for common_meg, position in zip(common_megs, common_logs):
        condition = log["condition"][position]
        if common_meg[2] == 20:
            assert condition == "fix"
        else:
            assert condition in ("sentence", "word_list")
        log.set("meg_time", [position], common_meg[0] / sfreq)
        span = log.span(last_idx + 1, log.index[position])
        times = [time[k] - last_log + last_meg / sfreq for k in span]
        assert np.all(np.isfinite(np.asarray(times, dtype=float)))
        log.set("meg_time", span, times)
        last_log = time[position]
        last_meg = common_meg[0]
        last_idx = log.index[position]
    span = log.span(last_idx + 1)
    log.set("meg_time", span,
            [time[k] - last_log + last_meg / sfreq for k in span])
    meg_time = [-1. if _isna(t) else t for t in log["meg_time"]]
    log.set("meg_time", range(len(log)), meg_time)
    meg_sample = np.array(np.asarray(meg_time) * sfreq, int)
    log.set("meg_sample", range(len(log)), meg_sample.tolist())
    n_out = int((meg_sample > last_sample).sum() + (meg_sample < 0).sum())
    if n_out:
        logger.warning("%d events outside the MEG recording removed", n_out)
    return log.take(np.flatnonzero((meg_sample <= last_sample)
                                   & (meg_sample >= 0)).tolist())


# ---------------------------------------------------------------------------
# Raw reading
# ---------------------------------------------------------------------------

def read_raw(raw_fname: tp.Union[str, Path]
             ) -> tp.Tuple[api.RawData, np.ndarray]:
    """(the MEG channels as RawData, the trigger events [N, 3]) of a CTF
    ``.ds`` (the 273 head sensors, the triggers from the stim channel), a
    FIF conversion (the 273 data channels after the 28 references) or an
    ``.npz`` stand-in (data, sample_rate, positions, events)."""
    raw_fname = str(raw_fname)
    if raw_fname.endswith(".npz"):
        payload = np.load(raw_fname, allow_pickle=False)
        raw = api.RawData(
            data=payload["data"].astype(np.float32),
            sample_rate=float(payload["sample_rate"]),
            ch_names=[f"c{k}" for k in range(payload["data"].shape[0])],
            positions=payload["positions"].astype(np.float32))
        return raw, payload["events"].astype(np.int64)
    if raw_fname.endswith(".fif"):
        full = read_fif(raw_fname)
        kinds = np.asarray(full.ch_kinds
                           or [FIFFV_MEG_CH] * full.n_channels)
        meg_idx = np.flatnonzero(kinds == FIFFV_MEG_CH)
        if len(meg_idx) > 273 + 28:
            meg_idx = meg_idx[28:28 + 273]
    elif raw_fname.endswith(".ds"):
        from .ctf import read_ctf
        full = read_ctf(Path(raw_fname))
        kinds = np.asarray(full.ch_kinds)
        meg_idx = np.flatnonzero(kinds == FIFFV_MEG_CH)[:273]
    else:
        raise ValueError(f"Unknown raw format: {raw_fname}")
    stim_idx = np.flatnonzero(kinds == FIFFV_STIM_CH)
    events = (find_events(full.data[stim_idx[0]])
              if len(stim_idx) else np.zeros((0, 3), dtype=np.int64))
    raw = api.RawData(
        data=np.ascontiguousarray(full.data[meg_idx]),
        sample_rate=full.sample_rate,
        ch_names=[full.ch_names[i] for i in meg_idx],
        positions=full.positions[meg_idx])
    return raw, events


# subjects left out: 2-run recordings or missing data
BAD_NUMS = [2011, 2036, 2062, 2063, 2076, 2084, 1006, 1014, 1090, 1115]
NO_SUBJECT = [1014, 1018, 1021, 1023, 1041, 1043, 1047, 1051, 1056, 1060,
              1067, 1082, 1091, 1096, 1112, 2012, 2018, 2022, 2023, 2026,
              2043, 2044, 2045, 2048, 2054, 2060, 2074, 2081, 2082, 2087,
              2093, 2100, 2107, 2112, 2115, 2118, 2123]


class Schoffelen2019Recording(api.Recording):

    data_url = ("https://data.donders.ru.nl/collections/di/dccn/"
                "DSC_3011020.09_236_v1")
    paper_url = "https://www.nature.com/articles/s41597-019-0020-y"
    doi = "https://doi.org/10.1038/s41597-019-0020-y"
    licence = "Donders"
    modality = "all"
    language = "nl"
    device = "meg"
    description = "204 subjects listened or read context-less sentences."

    @classmethod
    def iter(cls,  # type: ignore[override]
             events_filter: tp.Optional[str] = None, modality: str = "all"
             ) -> tp.Iterator["Schoffelen2019Recording"]:
        """The subjects of `modality` ("audio", "visual" or "all") whose
        raw and log exist. A study root without its download folder is
        mirrored from the Donders repository first (a warning where that
        fails)."""
        if modality not in ("visual", "audio", "all"):
            raise ValueError(f"Unknown modality: {modality}")
        try:
            study_paths = utils.StudyPaths("schoffelen2019")
        except EnvironmentError:
            return
        if not study_paths.download.exists():
            from . import download as dl
            parent, study = cls.data_url.rstrip("/").split("/")[-2:]
            try:
                dl.download_donders(study, study_paths.path, parent=parent)
            except dl.DownloadError as e:
                logger.warning("schoffelen2019 auto-download skipped: %s",
                               e)
        for num in itertools.chain(range(1001, 1118), range(2002, 2126)):
            if num in BAD_NUMS + NO_SUBJECT:
                continue
            subject_uid = f"sub-{'V' if num < 2000 else 'A'}{num}"
            recording = cls(subject_uid, events_filter)
            if not recording.paths_valid():
                continue
            if recording.modality == modality or modality == "all":
                yield recording

    def __init__(self, subject_uid: str,
                 events_filter: tp.Optional[str] = None) -> None:
        super().__init__(subject_uid=subject_uid, recording_uid=subject_uid)
        num = int(subject_uid[-4:])
        self.modality = "visual" if num < 2000 else "audio"
        assert subject_uid == f"sub-{self.modality[0].upper()}{num}"
        self.paths = StudyPaths(subject_uid)
        self._events_filter = events_filter

    def paths_valid(self) -> bool:
        try:
            _ = self.paths.raw
            _ = self.paths.metadata
        except RuntimeError:
            return False
        return True

    def _load_raw(self) -> api.RawData:
        raw, _ = read_raw(self.paths.raw)
        if raw.sample_rate != RAW_SAMPLE_RATE:
            raise RuntimeError("Raw has an unexpected sample rate")
        return raw

    def _load_events(self) -> EventTable:
        raw, trigger_events = read_raw(self.paths.raw)
        log = get_log_times(read_log(self.paths.metadata), trigger_events,
                            raw.sample_rate)
        log.rename(dict(start="offset", meg_time="start",
                        stop="legacy_stop", condition="kind"))
        cols = ["start", "duration", "kind", "context", "word", "filepath",
                "sequence_id", "word_index", "phoneme", "phoneme_id",
                "word_sequence", "sequence_uid", "offset"]
        cols = [c for c in cols if c in log]
        keep = log.where(k in ("word", "phoneme", "sound")
                         for k in log["kind"])
        events = EventTable.from_records([
            {name: log[name][k] for name in cols} for k in keep])
        # the context as `condition`, which events_filter selects on
        events = events.assign(condition=events["context"],
                               language=self.language,
                               modality=self.modality)
        return events.create_blocks(groupby="sentence_or_sound")

    def events(self, clean: bool = False) -> EventTable:
        """The events; with `clean`, only those `events_filter` keeps."""
        events = super().events()
        if clean and self._events_filter is not None:
            events = events.query(self._events_filter)
        return events
