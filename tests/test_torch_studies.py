"""The port's study adapters against the JAX package's, on the trees the
JAX tests write in each study's real format: the recordings, their raw
(bit-equal) and their events (every column and row: NaN where pandas has
NaN, the same block uids), the committed golden events, schoffelen2019's
events_filter and visual modality, the fake + fakeeeg padding to 273
sensors, the selection registry, the downloads against a local webdav
server, and AutoRejectDrop. Training on the studies is in
tests/test_torch_study_training.py."""

import json
import wave
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from scipy.io import savemat
from test_brennan_broderick import (write_brennan_fixture,
                                    write_broderick_gentle_fixture)
from test_download import dav_server  # noqa: F401  (a local server)
from test_gwilliams2022 import (write_gwilliams_fixture,
                                write_gwilliams_rich_fixture)
from test_schoffelen2019 import ALL_STIMULI, WORD_LISTS, write_mous_fixture

from brainmagick_tpu import autoreject as jautoreject
from brainmagick_tpu import studies as jstudies
from brainmagick_tpu import train as jtrain
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.studies import download as jdownload
from brainmagick_tpu.studies import schoffelen2019 as jschoffelen
from brainmagick_tpu.studies.broderick2019 import \
    _BroderickMetadata as JBroderickMetadata
from brainmagick_tpu_torch import autoreject, studies, train
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.studies import api, brennan2019, ctf, download
from brainmagick_tpu_torch.studies import io as fif
from brainmagick_tpu_torch.studies import schoffelen2019
from brainmagick_tpu_torch.studies.broderick2019 import _BroderickMetadata

GOLDEN = Path(__file__).parent / "golden"


def _mock_wav_by_name(value):
    """Each package writes the fake studies' mock wav into its own
    folder: that one path is compared by file name."""
    if isinstance(value, str) and "_mockdata" in value:
        return Path(value).name
    return value


def assert_events_equal(frame: pd.DataFrame, table) -> None:
    """`table` holds `frame`'s columns in its order, row for row: numbers
    of the same kind (int or float) and bits, NaN where pandas has NaN;
    anything else equal, None where pandas has NaN."""
    assert list(frame.columns) == table.columns
    assert len(frame) == len(table)
    for name in frame.columns:
        want, got = frame[name].to_numpy(), table[name]
        if want.dtype.kind in "fiu":
            assert got.dtype.kind == want.dtype.kind, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            want = [None if isinstance(v, float) and np.isnan(v)
                    else _mock_wav_by_name(v) for v in want.tolist()]
            assert [_mock_wav_by_name(v) for v in got.tolist()] == want, \
                name


def _both(study, root, tmp_path, **iter_kwargs):
    """(JAX recordings, port recordings) of `study` at `root`, each
    package with its own cache folder."""
    caches = [tmp_path / "jax_cache", tmp_path / "port_cache"]
    for cache in caches:
        cache.mkdir(parents=True, exist_ok=True)
    roots = {} if root is None else {study: root}
    with jenv.temporary(studies=roots, cache=caches[0]):
        jrecs = list(jstudies.register[study].iter(**iter_kwargs))
        for rec in jrecs:
            rec.raw(), rec.events()
    with env.temporary(studies=roots, cache=caches[1]):
        recs = list(studies.register[study].iter(**iter_kwargs))
        for rec in recs:
            rec.raw(), rec.events()
    assert [r.recording_uid for r in recs] \
        == [r.recording_uid for r in jrecs]
    assert len(recs)
    return jrecs, recs


def _assert_raw_equal(got: api.RawData, want) -> None:
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype
    assert got.ch_names == list(want.ch_names)
    assert got.ch_kinds == want.ch_kinds
    np.testing.assert_array_equal(got.positions, want.positions)
    assert got.sample_rate == want.sample_rate


def _assert_recordings_equal(jrecs, recs) -> None:
    for jrec, rec in zip(jrecs, recs):
        assert rec.subject_uid == jrec.subject_uid
        _assert_raw_equal(rec.raw(), jrec.raw())
        assert_events_equal(jrec.events(), rec.events())


def _golden_frame(table) -> pd.DataFrame:
    """The port's events as the golden CSVs hold them (wav basenames)."""
    frame = pd.DataFrame({name: table[name] for name in table.columns})
    if "filepath" in frame:
        frame["filepath"] = frame["filepath"].map(
            lambda p: Path(p).name if isinstance(p, str) and p else p)
    return frame


def _assert_golden(frame: pd.DataFrame, golden: pd.DataFrame,
                   atol: float) -> None:
    """The golden CSV's comparison, as the JAX tests make it."""
    assert sorted(frame.columns) == sorted(golden.columns)
    assert len(frame) == len(golden)
    for col in golden.columns:
        got, want = frame[col], golden[col]
        if pd.api.types.is_numeric_dtype(want) and not \
                pd.api.types.is_bool_dtype(want):
            np.testing.assert_allclose(
                pd.to_numeric(got).to_numpy(dtype=np.float64),
                want.to_numpy(dtype=np.float64), atol=atol,
                equal_nan=True, err_msg=col)
        else:
            assert got.fillna("").astype(str).tolist() == \
                want.fillna("").astype(str).tolist(), col


# -- gwilliams2022 ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fif", "con"])
def test_gwilliams_equals_the_jax_adapter(tmp_path, kind):
    """The BIDS tree with its raw as FIF or KIT .con: the MEG channels,
    the dict-literal events with sequence info and sentence blocks."""
    root = tmp_path / "gwilliams"
    write_gwilliams_fixture(root, kind)
    jrecs, recs = _both("gwilliams2022", root, tmp_path)
    _assert_recordings_equal(jrecs, recs)
    events = recs[0].events()
    assert events.kind_mask("block").sum() == 2
    assert recs[0].raw().n_channels == 16


def test_gwilliams_rich_tree_equals_jax_and_golden(tmp_path):
    """Three recordings (two sessions of a story), punctuation, phonemes,
    preset word_index and phoneme_id, mixed-case wav names: the JAX
    adapter's events and tests/golden/gwilliams_events.csv."""
    root = tmp_path / "rich"
    write_gwilliams_rich_fixture(root)
    jrecs, recs = _both("gwilliams2022", root, tmp_path)
    assert len(recs) == 3
    _assert_recordings_equal(jrecs, recs)
    frames = []
    for rec in recs:
        frame = _golden_frame(rec.events())
        frame["recording_uid"] = rec.recording_uid
        frames.append(frame)
    _assert_golden(pd.concat(frames, ignore_index=True),
                   pd.read_csv(GOLDEN / "gwilliams_events.csv"), 1e-9)


def test_gwilliams_ds_raw_and_no_root(tmp_path):
    """A CTF .ds raw takes the MEG channels; with no study root, iter
    yields nothing."""
    root = tmp_path / "gwilliams"
    write_gwilliams_fixture(root, "fif")
    meg = root / "download" / "sub-01" / "ses-0" / "meg"
    raw = fif.read_fif(meg / "sub-01_ses-0_task-0_meg.fif")
    raw.data = np.concatenate([raw.data * 1e-12, np.zeros((1, raw.n_times),
                                                          np.float32)])
    raw.ch_names = raw.ch_names + ["UPPT001"]
    raw.positions = np.concatenate([raw.positions, [[-0.1, -0.1]]]
                                   ).astype(np.float32)
    raw.ch_kinds = raw.ch_kinds + [ctf.KIND_STIM]
    ctf.write_ctf(meg / "sub-01_ses-0_task-0_meg.ds", raw)
    (meg / "sub-01_ses-0_task-0_meg.fif").unlink()
    jrecs, recs = _both("gwilliams2022", root, tmp_path)
    _assert_recordings_equal(jrecs, recs)
    assert recs[0].raw().n_channels == 16
    with env.temporary(studies={}):
        assert list(studies.register["gwilliams2022"].iter()) == []


# -- schoffelen2019 -----------------------------------------------------------

def _mous_raw_as(meg: Path, form: str) -> None:
    """The tree's npz stand-in replaced by a CTF .ds or a FIF conversion
    with a stim channel (tests/test_schoffelen2019.py's conversions)."""
    payload = np.load(meg / "testmeg-raw.npz")
    data, events = payload["data"], payload["events"]
    stim = np.zeros((1, data.shape[1]), dtype=np.float32)
    for sample, _, code in events:
        stim[0, sample:sample + 300] = code
    positions = np.concatenate([payload["positions"], [[-0.1, -0.1]]]
                               ).astype(np.float32)
    if form == "ds":
        raw = api.RawData(
            data=np.concatenate([data * 1e-12, stim]),
            sample_rate=float(payload["sample_rate"]),
            ch_names=[f"MLC{k:02d}" for k in range(len(data))]
            + ["UPPT001"], positions=positions,
            ch_kinds=[ctf.KIND_MEG] * len(data) + [ctf.KIND_STIM])
        ctf.write_ctf(meg / "sub-A2002_task-auditory_meg.ds", raw,
                      trial_samples=int(payload["sample_rate"]))
    else:
        raw = api.RawData(
            data=np.concatenate([data, stim]),
            sample_rate=float(payload["sample_rate"]),
            ch_names=[f"M{k}" for k in range(len(data))] + ["STI101"],
            positions=positions, ch_kinds=[1] * len(data) + [3])
        fif.write_fif(meg / "sub-A2002_task-auditory_meg.fif", raw)
    (meg / "testmeg-raw.npz").unlink()


@pytest.mark.parametrize("form", ["npz", "ds", "fif"])
def test_schoffelen_equals_the_jax_adapter(tmp_path, form):
    """Both modalities: the log parse, condition relabelling, TextGrid
    words and phonemes, the sentence uids, the log-to-MEG alignment and
    the sentence_or_sound blocks; the audio subject's raw as the npz
    stand-in, a CTF .ds or a FIF conversion."""
    root = tmp_path / "mous"
    write_mous_fixture(root)
    if form != "npz":
        _mous_raw_as(root / "download" / "sub-A2002" / "meg", form)
    jrecs, recs = _both("schoffelen2019", root, tmp_path)
    assert [r.modality for r in recs] == ["visual", "audio"]
    _assert_recordings_equal(jrecs, recs)
    audio = recs[1].events()
    words = audio[audio.kind_mask("word")]
    assert words["word"].tolist() == [w for s in ALL_STIMULI.values()
                                      for w in s.split()]
    assert abs(words["start"][0] - 2.51) < 0.02


def test_schoffelen_golden(tmp_path):
    """tests/golden/schoffelen_events.csv from the port's adapter."""
    root = tmp_path / "mous"
    write_mous_fixture(root)
    cache = tmp_path / "cache"
    cache.mkdir()
    columns = ["recording_uid", "start", "duration", "kind", "word",
               "word_index", "sequence_uid", "condition", "phoneme_id",
               "modality", "word_sequence"]
    frames = []
    with env.temporary(studies={"schoffelen2019": root}, cache=cache):
        for rec in studies.register["schoffelen2019"].iter():
            frame = _golden_frame(rec.events())
            frame["recording_uid"] = rec.recording_uid
            frames.append(frame)
    frame = pd.concat(frames, ignore_index=True)
    for col in columns:
        if col not in frame:
            frame[col] = np.nan
    golden = pd.read_csv(GOLDEN / "schoffelen_events.csv")
    frame = frame[columns].round(4)
    assert list(frame.columns) == list(golden.columns)
    _assert_golden(frame, golden, 1e-3)


@pytest.mark.parametrize("condition", ["sentence", "word_list"])
def test_schoffelen_events_filter(tmp_path, condition):
    """``events(clean=True)`` keeps the rows of `events_filter`, as the
    JAX adapter does (the audio_mous_wl selection's)."""
    root = tmp_path / "mous"
    write_mous_fixture(root)
    query = f'condition == "{condition}"'
    jrecs, recs = _both("schoffelen2019", root, tmp_path, modality="audio",
                        events_filter=query)
    with jenv.temporary(studies={"schoffelen2019": root}):
        want = jrecs[0].events(clean=True)
    got = recs[0].events(clean=True)
    assert_events_equal(want.reset_index(drop=True), got)
    assert set(got["condition"].tolist()) == {condition}
    assert len(recs[0].events()) > len(got)
    if condition == "word_list":
        words = got[got.kind_mask("word")]
        assert set(words["sequence_uid"].tolist()) == set(WORD_LISTS)


def test_schoffelen_visual_modality(tmp_path):
    """modality="visual": words from the Picture rows, no sounds."""
    root = tmp_path / "mous"
    write_mous_fixture(root)
    jrecs, recs = _both("schoffelen2019", root, tmp_path,
                        modality="visual")
    assert [r.recording_uid for r in recs] == ["sub-V1001"]
    _assert_recordings_equal(jrecs, recs)
    events = recs[0].events()
    assert not events.kind_mask("sound").any()
    assert set(events[events.kind_mask("word")]["modality"].tolist()) \
        == {"visual"}
    with pytest.raises(ValueError):
        list(studies.register["schoffelen2019"].iter(modality="tactile"))


@pytest.mark.parametrize("form", ["ds", "fif"])
def test_schoffelen_read_raw_equal(tmp_path, form):
    """read_raw on a .ds and a FIF conversion: the MEG picks and the
    triggers of the stim channel."""
    root = tmp_path / "mous"
    write_mous_fixture(root)
    meg = root / "download" / "sub-A2002" / "meg"
    _mous_raw_as(meg, form)
    path = next(meg.glob(f"*.{form}"))
    raw, events = schoffelen2019.read_raw(path)
    jraw, jevents = jschoffelen.read_raw(path)
    _assert_raw_equal(raw, jraw)
    np.testing.assert_array_equal(events, jevents)
    assert raw.n_channels == 12 and len(events) == 17


def test_schoffelen_log_pipeline_steps_equal(tmp_path):
    """The port's log, step by step, against pandas': every column of
    read_log and of get_log_times, in the same row order."""
    root = tmp_path / "mous"
    write_mous_fixture(root)
    with env.temporary(studies={"schoffelen2019": root}), \
            jenv.temporary(studies={"schoffelen2019": root}):
        for subject in ("sub-A2002", "sub-V1001"):
            paths = schoffelen2019.StudyPaths(subject)
            log = schoffelen2019.read_log(paths.metadata)
            jlog = jschoffelen.read_log(paths.metadata)
            _, events = schoffelen2019.read_raw(paths.raw)
            for got, want in ((log, jlog), (
                    schoffelen2019.get_log_times(log, events, 1200.),
                    jschoffelen.get_log_times(jlog, events, 1200.))):
                assert got.index == want.index.tolist()
                assert list(got.columns) == list(want.columns)
                for name in want.columns:
                    values = want[name].tolist()
                    assert [None if schoffelen2019._isna(v) else v
                            for v in got[name]] \
                        == [None if isinstance(v, float) and np.isnan(v)
                            else v for v in values], name


def test_schoffelen_blocks_stay_apart(tmp_path):
    """get_datasets merges blocks to dset.min_block_duration, except
    schoffelen2019's (one per sentence or sound), as the JAX package:
    the same windows in each split, from the 8 unmerged blocks."""
    root = tmp_path / "mous"
    write_mous_fixture(root)
    cache = tmp_path / "cache"
    cache.mkdir()
    cli = ['dset.selections=["audio_mous"]', "dset.n_recordings=1",
           'dset.features=["WordLength"]', "dset.condition=0.5",
           "dset.tmin=-0.2", "dset.tmax=0.6", "dset.allow_empty_split=True",
           f"cache={cache}", "num_workers=1"]
    jargs = jtrain.parse_overrides(cli)
    args = train.parse_overrides(cli + ["device=cpu"])
    assert args.dset.min_block_duration > 0
    with jenv.temporary(studies={"schoffelen2019": root}, cache=cache), \
            env.temporary(studies={"schoffelen2019": root}, cache=cache):
        want = jtrain.build_datasets(jargs)
        got = train.build_datasets(args)
    for split, jsplit in zip(got, want):
        assert [(d.blocks, d.event_samples.tolist()) for d in split.datasets] \
            == [(d.blocks, d.event_samples.tolist())
                for d in jsplit.datasets]
    assert sum(len(d.blocks) for split in got for d in split.datasets) \
        == len(ALL_STIMULI)


# -- brennan2019 and broderick2019 -----------------------------------------------

def test_brennan_equals_jax_and_golden(tmp_path):
    """The MATLAB proc and raw structs, the story CSV, the M10 layout:
    the JAX adapter's raw and events and tests/golden/brennan_events.csv."""
    root = tmp_path / "brennan"
    write_brennan_fixture(root)
    jrecs, recs = _both("brennan2019", root, tmp_path)
    _assert_recordings_equal(jrecs, recs)
    raw = recs[0].raw()
    assert raw.n_channels == 60 and raw.sample_rate == 500.
    np.testing.assert_array_equal(raw.positions,
                                  brennan2019.m10_positions(raw.ch_names))
    _assert_golden(_golden_frame(recs[0].events()),
                   pd.read_csv(GOLDEN / "brennan_events.csv"), 1e-9)


def test_broderick_parser_equals_jax_and_golden(tmp_path):
    """The gentle JSON and transcript parse (failed alignments, <unk>,
    fillers, a trailing unmatched word, punctuation tokens): the JAX
    parser's table and tests/golden/broderick_events.csv."""
    root = tmp_path / "broderick"
    write_broderick_gentle_fixture(root / "download" / "private")
    with jenv.temporary(studies={"broderick2019": root}):
        want = JBroderickMetadata()("1")
    with env.temporary(studies={"broderick2019": root}):
        got = _BroderickMetadata()("1")
    assert_events_equal(want, got)
    _assert_golden(_golden_frame(got),
                   pd.read_csv(GOLDEN / "broderick_events.csv"), 1e-9)


def write_broderick_tree(root: Path, n_sentences: int = 100,
                         runs=(1,)) -> None:
    """Subject 1's EEG runs (128 channels at 128 Hz) with each run's
    gentle alignment, transcript and wav: tests/test_brennan_broderick.py's
    broderick_root tree."""
    private = root / "download" / "private"
    private.mkdir(parents=True)
    eeg_dir = root / "download" / "Natural Speech" / "EEG" / "Subject1"
    eeg_dir.mkdir(parents=True)
    nouns = ["man", "sea", "boat", "fish", "line", "sail", "wind", "boy",
             "shark", "hand"]
    verbs = ["saw", "held", "pulled", "watched", "loved", "caught",
             "lost", "found", "heard", "felt"]
    text = " ".join(f"The old {nouns[k % 10]} {verbs[(k * 3) % 10]} the "
                    f"big {nouns[(k * 7 + 3) % 10]}."
                    for k in range(n_sentences))
    for run in runs:
        (private / f"oldman_run{run}.txt").write_text(text)
        t = 0.5
        entries = []
        for word in text.replace(".", "").split():
            dur = 0.05 * len(word) + 0.1
            phones = [dict(phone=f"{c}_B", duration=dur / 2)
                      for c in word[:2]]
            entries.append(dict(case="success", word=word,
                                alignedWord=word, start=round(t, 3),
                                end=round(t + dur, 3), phones=phones,
                                startOffset=0, endOffset=1))
            t += dur + 0.12
        (private / f"align{run}.json").write_text(json.dumps(
            dict(words=entries)))
        n = int(16000 * (t + 1))
        with wave.open(str(private / f"audio{run}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((np.sin(np.arange(n) * 0.07) * 15000
                           ).astype(np.int16).tobytes())
        savemat(eeg_dir / f"Subject1_Run{run}.mat", dict(
            fs=np.array([[128.0]]),
            eegData=np.random.RandomState(run).randn(
                int(128 * (t + 2)), 128).astype(np.float32)))


def test_broderick_equals_the_jax_adapter(tmp_path):
    root = tmp_path / "broderick"
    write_broderick_tree(root)
    caches = [tmp_path / "jax_cache", tmp_path / "port_cache"]
    for cache in caches:
        cache.mkdir()
    with jenv.temporary(studies={"broderick2019": root}, cache=caches[0]):
        jrecs = list(jstudies.register["broderick2019"].iter())
        jrec = jrecs[0]
        jrec.raw(), jrec.events()
    with env.temporary(studies={"broderick2019": root}, cache=caches[1]):
        recs = list(studies.register["broderick2019"].iter())
        rec = recs[0]
        rec.raw(), rec.events()
    assert [r.recording_uid for r in recs] \
        == [r.recording_uid for r in jrecs]
    assert len(recs) == 20
    _assert_recordings_equal([jrec], [rec])
    events = rec.events()
    assert rec.raw().n_channels == 128 and rec.raw().sample_rate == 128.
    assert len(set(events[events.kind_mask("word")]["sequence_id"]
                   .tolist())) >= 3


# -- fakeeeg, padding, selections ----------------------------------------------

def test_fakeeeg_equals_the_jax_study(tmp_path):
    cache = tmp_path / "fake_cache"
    jrecs, recs = _both("fakeeeg", None, cache)
    _assert_recordings_equal(jrecs, recs)
    assert recs[0].raw().n_channels == 64


MULTI = ['dset.selections=["fake", "fakeeeg"]', "dset.n_recordings=4",
         'dset.features=["MelSpectrum"]',
         'dset.features_params={"MelSpectrum": {"n_mels": 8}}',
         "dset.condition=2.0", "dset.tmin=-0.2", "dset.tmax=1.0",
         "dset.test_ratio=0.3", "dset.valid_ratio=0.2",
         "dset.min_n_blocks_per_split=1", "optim.loss=clip",
         "num_workers=1"]


def test_fake_and_fakeeeg_pad_to_273(tmp_path):
    """fake (273 MEG at 1200 Hz) + fakeeeg (64 EEG at 250 Hz): the
    recordings interleaved, the subject indices, and every train batch
    (EEG zero-padded to 273 channels, its padded positions invalid) as
    the JAX package's."""
    folder = tmp_path / "fake_cache"
    folder.mkdir()
    cli = MULTI + [f"cache={folder}"]
    jargs = jtrain.parse_overrides(cli)
    args = train.parse_overrides(cli + ["device=cpu"])
    with jenv.temporary(cache=folder), env.temporary(cache=folder):
        want = jtrain.build_datasets(jargs).train
        got = train.build_datasets(args).train
    assert [(d.recording.study_name(), d.recording.subject_index)
            for d in got.datasets] \
        == [(d.recording.study_name(), d.recording.subject_index)
            for d in want.datasets]
    assert {d.recording.study_name() for d in got.datasets} \
        == {"fake", "fakeeeg"}
    eeg = [k for k, d in enumerate(got.datasets)
           if d.recording.study_name() == "fakeeeg"][0]
    start = int(got.cumulative_sizes[eeg])
    indices = np.arange(start, start + 6)
    batch, jbatch = got.get_batch(indices), want.get_batch(indices)
    assert batch.meg.shape[1] == 273
    assert (batch.meg[:, 64:] == 0).all()
    assert (batch.positions[:, 64:] == api.INVALID_POSITION).all()
    for name in ("positions", "subject_index", "recording_index",
                 "features_mask"):
        np.testing.assert_array_equal(getattr(batch, name),
                                      getattr(jbatch, name), err_msg=name)
    scale = np.abs(jbatch.meg).max()
    np.testing.assert_allclose(batch.meg, jbatch.meg, rtol=0,
                               atol=1e-5 * scale)


def test_every_selection_resolves(tmp_path):
    """Each named selection's study is registered; with every study root
    set, from_selection yields the JAX package's recordings."""
    from brainmagick_tpu.studies.api import list_selections as jlist
    from brainmagick_tpu_torch.config import MainConfig

    got = [(cls.study_name(), params)
           for cls, params in studies.list_selections()]
    assert got == [(cls.study_name(), params) for cls, params in jlist()]
    roots = dict(gwilliams2022=tmp_path / "g", schoffelen2019=tmp_path / "m",
                 brennan2019=tmp_path / "b", broderick2019=tmp_path / "r")
    write_gwilliams_fixture(roots["gwilliams2022"], "con")
    write_mous_fixture(roots["schoffelen2019"])
    (roots["brennan2019"] / "download" / "proc").mkdir(parents=True)
    (roots["brennan2019"] / "download" / "proc" / "S01.mat").touch()
    write_broderick_tree(roots["broderick2019"])
    names = ["gwilliams2022", "audio_mous", "audio_mous_wl", "visual_mous",
             "brennan2019", "broderick2019", "fake", "fakeeeg"]
    selections = MainConfig().selections
    assert sorted(selections) == sorted(names)
    with env.temporary(studies=roots, cache=tmp_path / "fake_cache"), \
            jenv.temporary(studies=roots, cache=tmp_path / "fake_cache"):
        for name in names:
            recs = list(api.from_selection(selections[name]))
            jrecs = list(jstudies.from_selection(selections[name]))
            assert [r.recording_uid for r in recs] \
                == [r.recording_uid for r in jrecs], name
            assert recs, name


# -- downloads ---------------------------------------------------------------------

def test_download_donders_mirrors_the_tree(dav_server, tmp_path):  # noqa: F811
    """The port's webdav mirror against tests/test_download.py's local
    server, beside the JAX package's: the same files, the listing
    skipped, the success marker that makes a rerun a no-op."""
    trees = []
    for module, name in ((download, "port"), (jdownload, "jax")):
        dest = tmp_path / name
        module.download_donders("DSC_3011020.09_236", dest, parent="dccn",
                                user="alice", password="s3cret",
                                base_url=dav_server)
        root = dest / "download"
        trees.append({str(p.relative_to(root)): p.read_bytes()
                      for p in sorted(root.rglob("*")) if p.is_file()})
    assert trees[0] == trees[1]
    assert "index.html" not in trees[0] and "success.txt" in trees[0]
    download.download_donders("DSC_3011020.09_236", tmp_path / "port",
                              user="wrong", password="wrong",
                              base_url=dav_server)


def test_download_errors(tmp_path, monkeypatch):
    """No credentials, and a fetch that fails (an unreachable local
    port): DownloadError, as in the JAX package; a present file and an
    extracted archive are left as they are."""
    monkeypatch.delenv("DONDERS_USER", raising=False)
    monkeypatch.delenv("DONDERS_PASSWORD", raising=False)
    with pytest.raises(download.DownloadError, match="credentials"):
        download.download_donders("DSC_x", tmp_path / "x")
    with pytest.raises(download.DownloadError):
        download.download_file("http://127.0.0.1:9/none",
                               tmp_path / "f.bin")
    present = tmp_path / "present.bin"
    present.write_bytes(b"kept")
    assert download.download_file("http://127.0.0.1:9/none",
                                  present) == present
    import zipfile
    archive = tmp_path / "a.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr("inner/x.txt", "x")
    download.extract_zip(archive, tmp_path / "out")
    assert (tmp_path / "out" / "inner" / "x.txt").read_text() == "x"
    assert (tmp_path / "out" / ".extracted_a").exists()


def test_schoffelen_without_download_warns(tmp_path, monkeypatch, caplog):
    """A study root without its download folder and no credentials: the
    mirror is skipped with a warning and no recording is found."""
    monkeypatch.delenv("DONDERS_USER", raising=False)
    monkeypatch.delenv("DONDERS_PASSWORD", raising=False)
    with env.temporary(studies={"schoffelen2019": tmp_path / "empty"}):
        assert list(studies.register["schoffelen2019"].iter()) == []
    assert "auto-download skipped" in caplog.text


# -- autoreject -----------------------------------------------------------------

def _epochs(seed: int = 0):
    rng = np.random.RandomState(seed)
    epochs = rng.randn(60, 12, 80).astype(np.float32)
    bad = rng.rand(60, 12) < 0.08
    epochs[bad] *= 20.
    positions = rng.rand(12, 2).astype(np.float32)
    return epochs, positions


@pytest.mark.parametrize("seed", [0, 1])
def test_autoreject_equals_the_jax_packages(seed):
    """The thresholds, the reject log and the repaired epochs of the same
    seeded epochs, within 1e-6 relative."""
    epochs, positions = _epochs(seed)
    got = autoreject.AutoRejectDrop(seed=seed).fit(epochs, positions)
    want = jautoreject.AutoRejectDrop(seed=seed).fit(epochs, positions)
    np.testing.assert_allclose(got.threshes_, want.threshes_, rtol=1e-6)
    np.testing.assert_array_equal(got.get_reject_log(epochs),
                                  want.get_reject_log(epochs))
    repaired, log = got.transform(epochs, return_log=True)
    assert log.any()
    np.testing.assert_allclose(repaired, want.transform(epochs),
                               rtol=1e-6, atol=1e-6 * np.abs(epochs).max())
    np.testing.assert_allclose(got(epochs, positions),
                               jautoreject.AutoRejectDrop(seed=seed)(
                                   epochs, positions), rtol=1e-6,
                               atol=1e-6 * np.abs(epochs).max())


def test_autoreject_reaches_the_batches(tmp_path):
    """dset.autoreject=True: the dataset's epochs, repaired as the JAX
    package repairs them (a fit on 200 seeded epochs, then every epoch),
    within 1e-6 relative, take the recording's place in __getitem__ and
    get_batch."""
    folder = tmp_path / "fake_cache"
    folder.mkdir()
    cli = [c for c in MULTI if "selections" not in c and "n_recordings"
           not in c] + ['dset.selections=["fake"]', "dset.n_recordings=1",
                        "dset.autoreject=True", f"cache={folder}",
                        "device=cpu"]
    with env.temporary(cache=folder):
        dset = train.build_datasets(train.parse_overrides(cli)).train \
            .datasets[0]
    repaired = dset._meg_override
    assert repaired.shape == (len(dset), 273, dset._n_times)
    dset._meg_override = None
    epochs = np.stack([dset._get_meg(k) for k in range(len(dset))])
    dset._meg_override = repaired
    idx = np.random.RandomState(1234).permutation(len(epochs))[:200]
    positions = dset.raw.positions
    want = jautoreject.AutoRejectDrop().fit(epochs[idx], positions) \
        .transform(epochs, positions)
    assert (want != epochs).any()
    np.testing.assert_allclose(repaired, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    indices = np.arange(min(len(dset), 16))
    np.testing.assert_array_equal(dset.get_batch(indices).meg,
                                  repaired[indices])
    np.testing.assert_array_equal(dset[3].meg, repaired[3])
