"""The gwilliams2022 MEG study (MEG-MASC: 208-channel KIT at 1000 Hz, 27
subjects, four English stories in two sessions).

Port of ``brainmagick_tpu/studies/gwilliams2022.py``. The BIDS tree is
read without pandas: ``participants.tsv`` and each recording's
``events.tsv``, whose ``trial_type`` cells are python dict literals, go
through ``utils.read_csv``; the raw is a KIT ``.con`` (the release), a
CTF ``.ds`` or a FIF file, of which the MEG channels are kept. The
events get their sequence info and one block per sentence.
"""

from __future__ import annotations

import ast
import typing as tp
from itertools import product
from pathlib import Path

import numpy as np

from ..events import EventTable, extract_sequence_info
from . import api, utils
from .io import FIFFV_MEG_CH, read_fif

class Gwilliams2022Recording(api.Recording):
    data_url = ("https://drive.google.com/drive/u/0/folders/"
                "1u1l4oX_OfammKPT49OlgbAmjGGuaA4qE")
    paper_url = "https://www.biorxiv.org/content/10.1101/2020.04.04.025684v2"
    doi = "https://doi.org/10.1101/2020.04.04.025684"
    licence = ""
    modality = "audio"
    language = "en"
    device = "meg"
    description = ("21+ subjects listened to 4 stories, in 2 x 1h "
                   "identical sessions.")

    @classmethod
    def paths(cls) -> utils.StudyPaths:
        return utils.StudyPaths(cls.study_name())

    @classmethod
    def iter(cls  # type: ignore[override]
             ) -> tp.Iterator["Gwilliams2022Recording"]:
        """One recording per subject, session and story whose raw exists
        (none when the study has no root)."""
        try:
            paths = cls.paths()
        except EnvironmentError:
            return
        subject_file = paths.download / "participants.tsv"
        if not subject_file.exists():
            return
        subjects = [str(row["participant_id"]).split("-")[1]
                    for row in utils.read_csv(subject_file, sep="\t")]
        for subject, session, story in product(subjects, ("0", "1"),
                                               (str(k) for k in range(4))):
            bids_dir = (paths.download / f"sub-{subject}" / f"ses-{session}"
                        / "meg")
            stem = f"sub-{subject}_ses-{session}_task-{story}_meg"
            if not any((bids_dir / (stem + ext)).exists()
                       for ext in (".fif", ".con", ".ds")):
                continue
            yield cls(subject_uid=subject, session=session, story=story)

    def __init__(self, subject_uid: str, session: str, story: str) -> None:
        super().__init__(
            subject_uid=subject_uid,
            recording_uid=f"{subject_uid}_session{session}_story{story}")
        self.story = story
        self.session = session

    def _bids_stem(self) -> Path:
        return (self.paths().download / f"sub-{self.subject_uid}"
                / f"ses-{self.session}" / "meg"
                / f"sub-{self.subject_uid}_ses-{self.session}"
                  f"_task-{self.story}_meg")

    def _load_raw(self) -> api.RawData:
        """The raw's MEG channels, from ``.con``, ``.ds`` or ``.fif``."""
        stem = self._bids_stem()
        if stem.with_suffix(".con").exists():
            from .kit import read_kit
            raw = read_kit(stem.with_suffix(".con"))
        elif stem.with_suffix(".ds").exists():
            from .ctf import read_ctf
            raw = read_ctf(stem.with_suffix(".ds"))
        else:
            raw = read_fif(stem.with_suffix(".fif"))
        if raw.ch_kinds is not None:
            keep = np.flatnonzero(np.asarray(raw.ch_kinds) == FIFFV_MEG_CH)
            if len(keep) and len(keep) < raw.n_channels:
                raw = api.RawData(
                    data=np.ascontiguousarray(raw.data[keep]),
                    sample_rate=raw.sample_rate,
                    ch_names=[raw.ch_names[i] for i in keep],
                    positions=raw.positions[keep],
                    ch_kinds=[raw.ch_kinds[i] for i in keep])
        return raw

    def _load_events(self) -> EventTable:
        """The events.tsv rows (their dict-literal trial_type, onset and
        duration; a sound's file resolved to its lowercased stem), with
        sequence info and sentence blocks."""
        download = self.paths().download
        events_file = Path(str(self._bids_stem()).replace(
            "_meg", "_events")).with_suffix(".tsv")
        events = []
        for row in utils.read_csv(events_file, sep="\t"):
            event = ast.literal_eval(row["trial_type"])
            event["start"] = float(row["onset"])
            event["duration"] = float(row["duration"])
            if event.get("kind") == "sound":
                stem, _, ext = event["sound"].lower().rsplit(".", 2)
                event["filepath"] = str(download / (stem + "." + ext))
            events.append(event)
        table = EventTable.from_records(events).assign(
            language="english", modality="audio")
        return extract_sequence_info(table).create_blocks(groupby="sentence")
