"""The broderick2019 EEG study (128-channel Biosemi at 128 Hz, 19
subjects, 20 runs of the "Natural Speech" audiobook).

Port of ``brainmagick_tpu/studies/broderick2019.py``, without pandas:
each run's gentle forced alignment (``align<run>.json``) gives the word
and phoneme timings; its transcript (``oldman_run<run>.txt``), split into
sentences by a regex, is aligned to the JSON's words by Levenshtein
matching to give each row its sentence.
"""

from __future__ import annotations

import json
import math
import re
import typing as tp

import numpy as np

from ..events import EventTable, extract_sequence_info
from . import api, utils
from .fake import grid_positions


def get_paths() -> utils.StudyPaths:
    return utils.StudyPaths(Broderick2019Recording.study_name())


def _sentences(text: str) -> tp.List[str]:
    """Greedy sentence split on .!? followed by whitespace."""
    parts = re.split(r"(?<=[.!?])\s+", text.replace("\n", " "))
    return [p.strip() for p in parts if p.strip()]


class _BroderickMetadata:
    """A run's events: its gentle JSON aligned with its transcript, parsed
    once per study root and run."""

    def __init__(self) -> None:
        self._cache: tp.Dict[tp.Tuple[str, str], EventTable] = {}

    def _parse_json(self, run_id: str) -> tp.List[tp.Dict[str, tp.Any]]:
        """A leading ``sound`` row, then each word gentle located in the
        audio (``case == success``), followed by its phonemes (onsets
        summed from the word's); a located word gentle did not recognize
        (``<unk>``) has ``success=False``."""
        private = get_paths().download / "private"
        align = json.loads((private / f"align{run_id}.json").read_text())
        rows: tp.List[tp.Dict[str, tp.Any]] = [dict(
            start=0, kind="sound",
            filepath=str(private / f"audio{run_id}.wav"))]
        for w in align["words"]:
            if w["case"] != "success":
                continue
            ok = w["alignedWord"] != "<unk>"
            phones = w["phones"]
            rows.append(dict(
                start=w["start"], end=w["end"], success=ok,
                string=w["word"], aligned=w["alignedWord"], kind="word",
                phone=" ".join(p["phone"] for p in phones)))
            onsets = w["start"] + np.concatenate(
                [[0.0], np.cumsum([p["duration"] for p in phones])])
            rows += [dict(start=float(s), end=float(e), success=ok,
                          string=p["phone"], aligned=p["phone"],
                          kind="phoneme", phone=p["phone"])
                     for p, s, e in zip(phones, onsets[:-1], onsets[1:])]
        return rows

    def _parse_txt(self, run_id: str) -> tp.List[tp.Dict[str, tp.Any]]:
        """The transcript's tokens with their sentence and position; the
        tokens with no word character go after the positions are counted,
        so word_id counts every token of its sentence."""
        txt = (get_paths().download / "private"
               / f"oldman_run{run_id}.txt").read_text()
        records = [
            dict(word=re.sub(r"\W+", "", token), original_word=token,
                 word_id=word_id, sequence_id=sequence_id,
                 sequence_uid=sent)
            for sequence_id, sent in enumerate(_sentences(txt))
            for word_id, token in enumerate(sent.split())]
        return [r for r in records if r["word"] != ""]

    def __call__(self, run_id: str) -> EventTable:
        key = (str(get_paths().download), run_id)
        if key not in self._cache:
            self._cache[key] = self._process(run_id)
        return self._cache[key].copy()

    def _process(self, run_id: str) -> EventTable:
        """A matched word takes its transcript sentence's coordinates;
        every other row takes those of the nearest match before it (the
        rows before the first match, the first match's), except the rows
        after the last match, which stay missing."""
        rows = self._parse_json(run_id)
        text = self._parse_txt(run_id)
        words = [k for k, r in enumerate(rows) if r["kind"] == "word"]
        i, j = utils.match_list([rows[k]["string"].lower() for k in words],
                                [t["word"].lower() for t in text])
        assert len(i) > 450, f"suspiciously few matched words: {len(i)}"

        table = EventTable.from_records(rows)
        table = table.assign(duration=[
            r.get("end", math.nan) - r["start"] for r in rows])
        matched = {words[a]: text[b] for a, b in zip(i.tolist(), j.tolist())}
        last = max(matched)
        current = matched[min(matched)]
        coordinates = []
        for k in range(len(rows)):
            current = matched.get(k, current)
            coordinates.append(None if k > last else current)
        table = table.assign(**{
            name: [math.nan if c is None else c[name] for c in coordinates]
            for name in ("sequence_id", "sequence_uid", "word_id")})
        is_word = [r["kind"] == "word" for r in rows]
        is_phoneme = [r["kind"] == "phoneme" for r in rows]
        return table.assign(condition="sentence").assign(
            word=[r["string"] if w else math.nan
                  for r, w in zip(rows, is_word)]).assign(
            phoneme=[r["string"] if p else math.nan
                     for r, p in zip(rows, is_phoneme)]).assign(
            # gentle gives no ARPAbet id
            phoneme_id=[0 if p else math.nan for p in is_phoneme])


class Broderick2019Recording(api.Recording):

    data_url = "https://datadryad.org/stash/dataset/doi:10.5061/dryad.070jc"
    paper_url = "https://pubmed.ncbi.nlm.nih.gov/29478856/"
    doi = "https://doi.org/10.5061/dryad.070jc"
    licence = "CC0 1.0"
    modality = "audio"
    language = "english"
    device = "eeg"
    description = "128ch biosemi EEG, natural speech audiobook listening."
    _metadata = _BroderickMetadata()

    @classmethod
    def iter(cls  # type: ignore[override]
             ) -> tp.Iterator["Broderick2019Recording"]:
        """Runs 1 to 20 of each subject of ``Natural Speech/EEG`` (none
        when the study has no root)."""
        try:
            paths = get_paths()
        except EnvironmentError:
            return
        eeg_root = paths.download / "Natural Speech" / "EEG"
        if not eeg_root.exists():
            return
        subjects = sorted(
            int(f.name.split("Subject")[1]) for f in eeg_root.iterdir()
            if "Subject" in f.name)
        for subject in subjects:
            for run_id in range(1, 21):
                yield cls(subject_uid=str(subject), run_id=str(run_id))

    def __init__(self, subject_uid: str, run_id: str) -> None:
        super().__init__(subject_uid=subject_uid,
                         recording_uid=f"{subject_uid}_run{run_id}")
        self.run_id = run_id

    def _load_raw(self) -> api.RawData:
        from scipy.io import loadmat

        eeg_fname = (get_paths().download / "Natural Speech" / "EEG"
                     / f"Subject{self.subject_uid}"
                     / f"Subject{self.subject_uid}_Run{self.run_id}.mat")
        mat = loadmat(str(eeg_fname))
        assert mat["fs"][0][0] == 128
        eeg = np.asarray(mat["eegData"].T, dtype=np.float32) * 1e6
        assert len(eeg) == 128
        ch_names = [f"A{k + 1}" for k in range(128)]  # biosemi128 names
        return api.RawData(data=eeg, sample_rate=128.0, ch_names=ch_names,
                           positions=grid_positions(128))

    def _load_events(self) -> EventTable:
        events = self._metadata(self.run_id).assign(
            language=self.language, modality=self.modality)
        events = extract_sequence_info(events, phoneme=False)
        return events.create_blocks(groupby="sentence")
