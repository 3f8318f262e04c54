"""The brennan2019 EEG study (60 channels at 500 Hz, 33 subjects kept,
the first chapter of Alice in Wonderland).

Port of ``brainmagick_tpu/studies/brennan2019.py``, without pandas: each
subject's MATLAB ``proc`` struct gives the word trials, joined row for row
with ``AliceChapterOne-EEG.csv``; the MATLAB ``raw`` struct holds the EEG
(in µV, kept as volts). The layout is easycap's M10 montage, built from
its geometry.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np

from ..events import EventTable, extract_sequence_info
from . import api, utils

SFREQ = 500.0

BAD_SUBJECTS = ["S24", "S26", "S27", "S30", "S32", "S34", "S35", "S36", "S02"]


def get_paths() -> utils.StudyPaths:
    return utils.StudyPaths(Brennan2019Recording.study_name())


# -- easycap-M10 montage -----------------------------------------------------
# The M10 has 61 equidistant sites: a vertex electrode and rings of
# 6/12/18/24 sites at polar angles of 23/46/69/92 degrees, numbered ring
# by ring from the front (nose), clockwise seen from above. Site 29 was
# the online reference in Brennan2019, so the data channels are "1".."28",
# "30".."61". Each site maps to (theta_deg, phi_deg), phi 90 = front.
_M10_RINGS = ((0.0, 1), (23.0, 6), (46.0, 12), (69.0, 18), (92.0, 24))


def easycap_m10() -> tp.Dict[int, tp.Tuple[float, float]]:
    table: tp.Dict[int, tp.Tuple[float, float]] = {}
    site = 1
    for theta, count in _M10_RINGS:
        for k in range(count):
            table[site] = (theta, 90.0 - k * 360.0 / count)
            site += 1
    return table


def m10_positions(ch_names: tp.Sequence[str]) -> np.ndarray:
    """The normalized 2D layout of channels named by M10 site number
    (azimuthal-equidistant from the vertex; x right, y front)."""
    table = easycap_m10()
    out = np.full((len(ch_names), 2), api.INVALID_POSITION,
                  dtype=np.float32)
    raw = np.zeros((len(ch_names), 2), dtype=np.float64)
    valid = np.zeros(len(ch_names), dtype=bool)
    for i, name in enumerate(ch_names):
        try:
            theta, phi = table[int(name)]
        except (ValueError, KeyError):
            continue
        raw[i] = (theta * np.cos(np.deg2rad(phi)),
                  theta * np.sin(np.deg2rad(phi)))
        valid[i] = True
    if valid.any():
        lo, hi = raw[valid].min(axis=0), raw[valid].max(axis=0)
        span = np.maximum(hi - lo, 1e-9)
        out[valid] = ((raw[valid] - lo) / span).astype(np.float32)
    return out


def _read_meta(fname) -> EventTable:
    """A subject's events: its proc struct's trials beside the story's
    rows, one sound per audio segment, sequence info and sentence
    blocks."""
    from scipy.io import loadmat

    proc = loadmat(fname, squeeze_me=True, chars_as_strings=True,
                   struct_as_record=True, simplify_cells=True)["proc"]
    trl = proc["trl"]
    assert len(trl) == proc["tot_trials"]
    columns = list(proc["varnames"])
    if len(columns) != trl.shape[1]:
        columns = ["start_sample", "stop_sample", "offset"] + columns
        assert len(columns) == trl.shape[1]
    assert len(trl) == 2129
    paths = get_paths()
    story = utils.read_csv(paths.download / "AliceChapterOne-EEG.csv")
    names = {name: None for row in story for name in row}
    events = []
    for k, values in enumerate(trl.tolist()):
        row = {"_" + c: v for c, v in zip(columns, values)}
        # the story's row k, or missing cells where it has fewer rows
        row.update(story[k] if k < len(story)
                   else {name: math.nan for name in names})
        row["kind"] = "word"
        row["condition"] = "sentence"
        row["duration"] = row["offset"] - row["onset"]
        events.append(row)
    renames = dict(Word="word", Position="word_id", Sentence="sequence_id")
    events = [{renames.get(k, k): v for k, v in row.items()}
              for row in events]
    for row in events:
        row["start"] = row["_start_sample"] / SFREQ

    # one sound per audio segment (the segments in sorted order); a wav
    # may start before the EEG's onset
    wav_file = str(paths.download / "audio"
                   / "DownTheRabbitHoleFinal_SoundFile%i.wav")
    first: tp.Dict[tp.Any, dict] = {}
    for row in events:
        if not _is_nan(row["Segment"]):
            first.setdefault(row["Segment"], row)
    sounds = [dict(kind="sound", start=row["start"] - row["onset"],
                   filepath=wav_file % segment)
              for segment, row in sorted(first.items())]
    keep = ["start", "duration", "kind", "word", "word_id", "sequence_id",
            "condition", "filepath"]
    table = EventTable.from_records(events + sounds).sort_by_start()
    table = EventTable({name: table[name] for name in keep})
    table = table.assign(language="english", modality="audio")
    table = extract_sequence_info(table)
    return table.create_blocks(groupby="sentence").validate()


def _is_nan(value: tp.Any) -> bool:
    return isinstance(value, float) and math.isnan(value)


def _read_eeg(fname) -> api.RawData:
    """The 60 EEG channels of a subject's MATLAB raw struct (VEOG and AUD
    dropped), in volts."""
    from scipy.io import loadmat

    mat = loadmat(str(fname), squeeze_me=True, chars_as_strings=True,
                  struct_as_record=True, simplify_cells=True)["raw"]
    sfreq = mat["hdr"]["Fs"]
    assert sfreq == SFREQ and mat["fsample"] == sfreq
    ch_names = list(mat["hdr"]["label"])
    assert ch_names[60] == "VEOG"
    data = np.asarray(mat["trial"], dtype=np.float32)
    assert data.shape[0] == len(ch_names)
    data = data[:60] * 1e-6
    ch_names = ch_names[:60]
    return api.RawData(data=data, sample_rate=float(sfreq),
                       ch_names=ch_names, positions=m10_positions(ch_names))


class Brennan2019Recording(api.Recording):

    data_url = ("https://deepblue.lib.umich.edu/data/concern/data_sets/"
                "bg257f92t")
    paper_url = ("https://journals.plos.org/plosone/article?id=10.1371/"
                 "journal.pone.0207741")
    doi = "https://doi.org/10.1371/journal.pone.0207741"
    licence = "CC BY 4.0"
    modality = "audio"
    language = "english"
    device = "eeg"
    description = ("EEG of Alice in Wonderland (Brennan & Hale 2019), "
                   "0.1-200Hz.")

    @classmethod
    def iter(cls  # type: ignore[override]
             ) -> tp.Iterator["Brennan2019Recording"]:
        """One recording per subject of ``download/proc`` (the bad
        subjects aside; none when the study has no root)."""
        try:
            paths = get_paths()
        except EnvironmentError:
            return
        proc = paths.download / "proc"
        if not proc.exists():
            return
        subjects = sorted(
            f.name.split(".")[0] for f in proc.iterdir()
            if f.name.startswith("S") and f.name.endswith(".mat"))
        for subject in subjects:
            if subject in BAD_SUBJECTS:
                continue
            yield cls(subject_uid=subject)

    def __init__(self, subject_uid: str) -> None:
        super().__init__(subject_uid=subject_uid, recording_uid=subject_uid)

    def _load_raw(self) -> api.RawData:
        return _read_eeg(get_paths().download / f"{self.subject_uid}.mat")

    def _load_events(self) -> EventTable:
        return _read_meta(get_paths().download / "proc"
                          / f"{self.subject_uid}.mat")
