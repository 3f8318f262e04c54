"""The port's data path against the JAX package's on the fake study: the
events (every column, every row, pandas' row order), the block helpers,
the mock wav, the feature tracks, the splits, the loader's batches, the
scaler's exported arrays, the XP signature, and the backend tag that
keeps the two packages' cache entries apart.

Both packages preprocess the same two fake recordings once, into one
shared cache folder (the module's ``study`` fixture)."""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from brainmagick_tpu import cache as jcache
from brainmagick_tpu import dataset as jdataset
from brainmagick_tpu import events as jevents
from brainmagick_tpu import loader as jloader
from brainmagick_tpu import mockdata as jmockdata
from brainmagick_tpu import norm as jnorm
from brainmagick_tpu import train as jtrain
from brainmagick_tpu.config import MainConfig as JaxMainConfig
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.studies import fake as jfake
from brainmagick_tpu_torch import cache, dataset, events, loader, mockdata
from brainmagick_tpu_torch import norm, train
from brainmagick_tpu_torch.config import MainConfig
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.studies import fake

#: the fake study's shape, cut to two recordings
OVERRIDES = ['dset.selections=["fake"]', "dset.n_recordings=2",
             'dset.features=["MelSpectrum", "WordLength"]',
             'dset.features_params={"MelSpectrum": {"n_mels": 8}}',
             "dset.condition=1.0", "dset.tmin=-0.2", "dset.tmax=1.0",
             "dset.test_ratio=0.3", "dset.valid_ratio=0.2",
             "dset.min_n_blocks_per_split=1", "optim.loss=clip",
             "optim.batch_size=8", "seed=1234", "num_workers=2"]
#: the mel spectrogram's tolerance, in log10 units
MEL_TOL = 1e-4
#: the MEG's tolerance, as a share of max|meg|
MEG_TOL = 1e-5


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """Both packages' datasets of OVERRIDES, cached in one folder."""
    root = tmp_path_factory.mktemp("data")
    folder = root / "fake_cache"
    folder.mkdir()
    cli = OVERRIDES + [f"cache={folder}", f"out_dir={root / 'outputs'}"]
    jargs = jtrain.parse_overrides(cli)
    args = train.parse_overrides(cli + ["device=cpu"])
    with jenv.temporary(cache=folder), env.temporary(cache=folder):
        yield types.SimpleNamespace(
            folder=folder, args=args, jargs=jargs,
            jax=jtrain.build_datasets(jargs),
            port=train.build_datasets(args))


def _frame_columns_equal(frame: pd.DataFrame, table) -> None:
    """Every column of `frame` in `table`, row for row: NaN where the
    table has NaN (numbers) or None (anything else); wav paths by name."""
    assert list(frame.columns) == table.columns
    for name in frame.columns:
        want, got = frame[name].to_numpy(), table[name]
        if name == "filepath":
            want = [None if pd.isna(v) else Path(v).name for v in want]
            got = [None if v is None else Path(v).name for v in got]
            assert want == got
        elif want.dtype.kind in "fi":
            assert got.dtype.kind == want.dtype.kind, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            want = [None if (isinstance(v, float) and np.isnan(v)) else v
                    for v in want.tolist()]
            assert want == got.tolist(), name


@pytest.mark.parametrize("seed", [1234, 1237])
def test_fake_events_equal_the_jax_packages(seed):
    want = jfake.make_fake_events(total_duration=99_999 / 1200, seed=seed)
    got = fake.make_fake_events(total_duration=99_999 / 1200, seed=seed)
    assert len(got) == len(want) > 100
    _frame_columns_equal(want, got)


@pytest.mark.parametrize("seed", [1234, 1235])
def test_sort_by_start_is_pandas_order(seed):
    """A word and its phoneme share a start: the port's sort puts the
    rows in the order of pandas' (unstable) ``sort_values("start")``."""
    frame = jfake.make_fake_events(total_duration=99_999 / 1200, seed=seed)
    table = fake.make_fake_events(total_duration=99_999 / 1200, seed=seed)
    starts = frame["start"].to_numpy()
    assert len(np.unique(starts)) < len(starts)
    want = frame.assign(row=np.arange(len(frame))).sort_values("start")
    got = table.assign(row=np.arange(len(table))).sort_by_start()
    np.testing.assert_array_equal(got["row"], want["row"].to_numpy())
    _frame_columns_equal(want, got)


def test_sort_by_start_puts_nan_last():
    frame = pd.DataFrame(dict(kind=["word"] * 5,
                              start=[2., np.nan, 1., np.nan, 1.]))
    table = events.EventTable.from_records(frame.to_dict("records"))
    want = frame.assign(row=np.arange(5)).sort_values("start")
    got = table.assign(row=np.arange(5)).sort_by_start()
    np.testing.assert_array_equal(got["row"], want["row"].to_numpy())


def test_block_helpers_equal_the_jax_packages():
    """merge_blocks, assign_blocks (the same seeded draw per uid, with and
    without a removed split) and split_wav_as_block."""
    frame = jfake.make_fake_events(total_duration=99_999 / 1200, seed=1234)
    table = fake.make_fake_events(total_duration=99_999 / 1200, seed=1234)
    jblocks = frame[frame.kind == "block"]
    blocks = table[table.kind_mask("block")]
    _frame_columns_equal(jevents.merge_blocks(jblocks, 6.),
                         events.merge_blocks(blocks, 6.))
    _frame_columns_equal(frame.event.merge_blocks(6.),
                         table.merge_blocks(6.))
    for kwargs in (dict(), dict(remove_ratio=0.1)):
        want = jevents.assign_blocks(jblocks, [0.3, 0.2], seed=12,
                                     min_n_blocks_per_split=1, **kwargs)
        got = events.assign_blocks(blocks, [0.3, 0.2], seed=12,
                                   min_n_blocks_per_split=1, **kwargs)
        _frame_columns_equal(want.reset_index(drop=True), got)
        assert len(set(got["split"].tolist())) == 3
    splits = jevents.assign_blocks(jblocks, [0.3, 0.2], seed=12,
                                   min_n_blocks_per_split=1)
    # the test split's blocks, and a block edge inside a sound event
    bounds = [(b.start, b.start + b.duration)
              for b in splits[splits.split == 0].itertuples()]
    bounds.append((bounds[0][0] + 0.5, bounds[0][1]))
    _frame_columns_equal(jevents.split_wav_as_block(frame, bounds),
                         events.split_wav_as_block(table, bounds))


def test_assign_blocks_refuses_a_thin_split():
    table = fake.make_fake_events(total_duration=20, seed=1234)
    with pytest.raises(ValueError, match="fewer than"):
        events.assign_blocks(table[table.kind_mask("block")], [0.3, 0.2],
                             seed=12, min_n_blocks_per_split=20)


def test_query_supports_field_equals_value_only():
    """``field==value`` terms select their rows; the query's wider subset
    (comparisons, ``and``) is held to pandas in tests/test_torch_query.py,
    and arithmetic stays refused."""
    table = fake.make_fake_events(total_duration=20, seed=1234)
    words = table.query("kind=='word'")
    assert len(words) == int(table.kind_mask("word").sum()) > 0
    assert len(table.query('word == "de"')) > 0
    later = table.query("kind=='word' and start > 3")
    assert 0 < len(later) < len(words) and (later["start"] > 3).all()
    with pytest.raises(NotImplementedError):
        table.query("start + 1 > 3")


def test_mock_wav_is_bit_equal(tmp_path):
    """Synthesized afresh, the port's mock wav has the JAX package's
    bytes; the package's own copy too."""
    want = jmockdata.mock_wav_path().read_bytes()
    fresh = mockdata.mock_wav_path(tmp_path)
    assert fresh.parent == tmp_path
    assert fresh.read_bytes() == want
    assert mockdata.mock_wav_path().read_bytes() == want


def _pairs(study, split):
    jax_sets = getattr(study.jax, split).datasets
    port_sets = getattr(study.port, split).datasets
    assert len(jax_sets) == len(port_sets) > 0
    return list(zip(jax_sets, port_sets))


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_splits_and_sample_positions_equal(study, split):
    assert len(getattr(study.port, split)) == len(getattr(study.jax, split))
    for jset, pset in _pairs(study, split):
        assert pset.recording.recording_uid == jset.recording.recording_uid
        assert pset.recording.subject_index == jset.recording.subject_index
        assert pset.recording.recording_index \
            == jset.recording.recording_index
        np.testing.assert_array_equal(pset.event_samples,
                                      jset.event_samples)
        assert pset.blocks == jset.blocks
        np.testing.assert_array_equal(pset._get_positions(),
                                      jset._get_positions())


def test_preprocessed_raw_matches_jax(study):
    for jset, pset in _pairs(study, "train"):
        want = np.asarray(jset.raw.data)
        got = np.asarray(pset.raw.data)
        assert got.shape == want.shape == (273, 9999)
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"preprocessed raw: max |port - jax| / max|x| = {err:.2e}")
        assert err <= MEG_TOL


def test_tracks_match_jax(study):
    """The test split paints MelSpectrum (to MEL_TOL), WordLength and
    WordHash (equal) and the word mask (equal)."""
    for jset, pset in _pairs(study, "test"):
        assert list(pset.features) == list(jset.features) \
            == ["MelSpectrum", "WordLength", "WordHash"]
        (want, want_sr), (got, got_sr) = jset._get_track(), pset._get_track()
        assert float(got_sr) == float(want_sr)
        assert got.shape == want.shape
        mel = pset.features.get_slice("MelSpectrum")
        print(f"MelSpectrum track: max |port - jax| = "
              f"{np.abs(got[mel] - want[mel]).max():.2e} log10 units")
        np.testing.assert_allclose(got[mel], want[mel], rtol=0,
                                   atol=MEL_TOL)
        rest = np.r_[mel.stop:got.shape[0]]
        np.testing.assert_array_equal(got[rest], want[rest])
        assert (got[-1] > 0).any() and (got[pset.features.get_slice(
            "WordHash")] != 0).any()


def _assert_batches_equal(got, want):
    err = np.abs(got.meg - want.meg).max() / np.abs(want.meg).max()
    assert err <= MEG_TOL, err
    np.testing.assert_allclose(got.features, want.features, rtol=0,
                               atol=MEL_TOL)
    for name in ("features_mask", "subject_index", "recording_index",
                 "positions"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.parametrize("split,shuffle,drop_last",
                         [("train", True, True), ("valid", False, False),
                          ("test", True, False)])
def test_loader_batches_equal(study, split, shuffle, drop_last):
    """The same batches for a seed and an epoch: the shuffled order, the
    dropped or padded last batch (pad_weight 0 on the copies)."""
    kwargs = dict(batch_size=8, shuffle=shuffle, seed=1234,
                  drop_last=drop_last, num_workers=2)
    jl = jloader.Loader(getattr(study.jax, split), **kwargs)
    pl = loader.Loader(getattr(study.port, split), **kwargs)
    jl.set_epoch(1)
    pl.set_epoch(1)
    assert len(pl) == len(jl) >= 2
    n = 0
    for (got, got_w), (want, want_w) in zip(pl, jl):
        _assert_batches_equal(got, want)
        np.testing.assert_array_equal(got_w, want_w)
        n += 1
    assert n == len(jl)
    if not drop_last and len(getattr(study.jax, split)) % 8:
        assert got_w.min() == 0.


def test_device_loader_yields_tensors(study):
    """With a device the loader yields tensors in assemble_dtype, int64
    indices, and pad_weight, the same values as the host loader's."""
    kwargs = dict(batch_size=8, shuffle=True, seed=1234, num_workers=2)
    host = next(iter(loader.Loader(study.port.train, **kwargs)))
    for dtype in (None, "bfloat16"):
        got, weight = next(iter(loader.Loader(
            study.port.train, device="cpu", assemble_dtype=dtype,
            **kwargs)))
        assert got.meg.dtype == (torch.bfloat16 if dtype else torch.float32)
        assert got.recording_index.dtype == torch.int64
        np.testing.assert_array_equal(weight.numpy(), host[1])
        np.testing.assert_allclose(got.meg.float().numpy(), host[0].meg,
                                   rtol=1e-2 if dtype else 0, atol=0)
    with pytest.raises(ValueError):
        loader.Loader(study.port.train, batch_size=8,
                      assemble_dtype="bfloat16")


@pytest.mark.parametrize("inputs", ["same", "own"])
def test_scaler_exports_match_jax(study, inputs):
    """``BatchScaler.fit`` draws the same epochs: on the JAX package's
    datasets ("same") the exported arrays agree to rtol 1e-5; on the
    port's own ("own") the MEG statistics move with the preprocessed raw
    (within MEG_TOL of max|meg|) and the features' with the mel
    spectrogram (within MEL_TOL)."""
    jset = study.jax.train.datasets
    pset = jset if inputs == "same" else study.port.train.datasets
    kwargs = dict(n_samples_per_recording=20, n_samples_features=100)
    want = jnorm.BatchScaler(jset[0].features, **kwargs).fit(jset)
    got = norm.BatchScaler(pset[0].features, **kwargs).fit(pset)
    want_arrays = want.export_arrays(3, 273)
    got_arrays = got.export_arrays(3, 273)
    assert set(got_arrays) == set(want_arrays)
    meg_scale = max(np.abs(np.asarray(d.raw.data)).max() for d in jset)
    for name, value in want_arrays.items():
        assert got_arrays[name].dtype == value.dtype
        if inputs == "same":
            np.testing.assert_allclose(got_arrays[name], value, rtol=1e-5,
                                       err_msg=name)
        else:
            atol = MEG_TOL * meg_scale if name.startswith("meg") \
                else MEL_TOL
            print(f"scaler {name}: max |port - jax| = "
                  f"{np.abs(got_arrays[name] - value).max():.2e}")
            np.testing.assert_allclose(got_arrays[name], value, rtol=0,
                                       atol=atol, err_msg=name)
    assert (got_arrays["meg_scale"][:2] != 1).all()
    np.testing.assert_array_equal(got_arrays["meg_scale"][2], 1)


@pytest.mark.parametrize("cli", [
    [], OVERRIDES, ["preset=clip_conv", "optim.epochs=2",
                    "simpleconv.fused_conv_bn=True"],
    ["preset=clip_conv_tpu", 'dset.selections=["fake"]'],
    ["preset=deep_mel"], ["preset=clip_conv", "preset=deep_mel"],
    ["preset=clip_conv_tpu", "preset=deep_mel",
     "feature_model_params.n_hidden_layers=3"],
    ["device=cpu", "num_workers=7", "cache=/x", "out_dir=/y"],
    ["simpleconv.merger_pos_dim=__deleted__"]], ids=str)
def test_sig_is_the_jax_packages(cli):
    """The same overrides give the same XP signature and delta (the
    device and the other cosmetic keys are not in it)."""
    args = train.parse_overrides(cli)
    jargs = jtrain.parse_overrides(cli, JaxMainConfig())
    assert args.delta() == jargs.delta()
    assert args.sig == jargs.sig
    assert args.xp_folder == jargs.xp_folder


def test_cache_entries_carry_the_backend_tag(study, tmp_path):
    """The port's keys and file names carry ``cache.BACKEND``, so it reads
    no entry the JAX package writes into the same folder, and the JAX
    package none of the port's."""
    assert cache.tagged("meg-sr120.npy") == "meg-sr120-torch.npy"
    folder = tmp_path / "shared"
    key = dict(a=1, b=[2., "x"])
    with jenv.temporary(cache=folder), env.temporary(cache=folder):
        assert jcache.Cache("scaler", key).get(lambda: "jax") == "jax"
        assert cache.Cache("scaler", key).get(lambda: "torch") == "torch"
        assert jcache.Cache("scaler", key).get(lambda: "new") == "jax"
        assert cache.Cache("scaler", key).get(lambda: "new") == "torch"
        jax_files = list(jcache.Cache("scaler", key).path.iterdir())
        port_files = list(cache.Cache("scaler", key).path.iterdir())
    assert len(jax_files) == len(port_files) == 1
    assert cache.BACKEND in str(port_files[0]) \
        and cache.BACKEND not in str(jax_files[0])
    # the preprocessed raw: both files side by side; the port reads its
    # own even when the JAX package's is overwritten
    folder = study.folder / "studies" / "fake" / "0"
    assert sorted(p.name for p in folder.iterdir()) == [
        "events-torch.pkl", "events.csv", "meg-sr120-hp0.0-dsp2-torch.npy",
        "meg-sr120-hp0.0-dsp2.npy", "meta-torch.json", "meta.json"]
    np.save(folder / "meg-sr120-hp0.0-dsp2.npy",
            np.zeros((273, 9999), np.float32))
    with env.temporary(cache=study.folder):
        recording = next(fake.FakeRecording.iter())
        got = recording.preprocessed(120, highpass=0.)
    assert isinstance(got.data, np.memmap)
    np.testing.assert_array_equal(
        got.data, study.port.train.datasets[0].raw.data)


def test_get_datasets_refuses_autoreject():
    """The factory no longer refuses dset.autoreject: it keeps the option
    (the repair it applies is held to the JAX package's in
    tests/test_torch_studies.py)."""
    assert dataset.SegmentDataset.Factory(autoreject=True).autoreject
    assert not dataset.SegmentDataset.Factory().autoreject


def test_cli_refuses_a_missing_card():
    """device defaults to "cuda"; without a CUDA device the CLI raises at
    once, and device=cpu is the only way onto the CPU."""
    assert MainConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="device=cpu"):
        train.main(["optim.epochs=1"])
    assert train.get_device(train.parse_overrides(["device=cpu"])) \
        == torch.device("cpu")
    with pytest.raises(ValueError):
        train.get_device(train.parse_overrides(["device=tpu"]))


def test_segment_batch_fields_are_the_jax_packages():
    assert dataset.ARRAY_FIELDS == jdataset.SegmentBatch.ARRAY_FIELDS
    assert [f.name for f in dataclasses.fields(dataset.SegmentBatch)] \
        == [f.name for f in dataclasses.fields(jdataset.SegmentBatch)]


#: every feature of features/basic.py
BASIC = ["WordPulse", "PhonemePulse", "WordSegment", "Modality",
         "WordLength", "WordIndex", "WordFrequency", "Phoneme", "WordHash"]


@pytest.mark.parametrize("event_mask", [False, True])
def test_basic_feature_tracks_equal(event_mask):
    """Every word and phoneme feature painted over a whole fake recording
    (and the word mask) equals the JAX package's track."""
    from brainmagick_tpu.features import FeaturesBuilder as JaxBuilder
    from brainmagick_tpu.utils import Frequency as JaxFrequency
    from brainmagick_tpu_torch.features import FeaturesBuilder
    from brainmagick_tpu_torch.utils import Frequency

    frame = jfake.make_fake_events(total_duration=40, seed=1236)
    table = fake.make_fake_events(total_duration=40, seed=1236)
    params = {"WordHash": {"buckets": 1000}}
    want = JaxBuilder(frame, BASIC, params, JaxFrequency(120.),
                      event_mask=event_mask)
    got = FeaturesBuilder(table, BASIC, params, Frequency(120.),
                          event_mask=event_mask)
    assert got.dimension == want.dimension
    assert got.output_dimension == want.output_dimension
    for name in BASIC:
        assert got.get_slice(name, model_output=True) \
            == want.get_slice(name, model_output=True)
    want_data, want_mask = want.render_track(40.)
    got_data, got_mask = got.render_track(40.)
    np.testing.assert_array_equal(got_data, want_data)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert (got_data != 0).any(axis=1).all()


def test_extract_sequence_info_equals_the_jax_packages():
    """word_index (multi-word entries counted), word_sequence and
    phoneme_id filled from sequence_id where they are missing."""
    records = [dict(kind="word", start=float(k), duration=0.3, word=w,
                    sequence_id=s, modality="audio", language="nl")
               for k, (w, s) in enumerate([("a b", 0), ("c", 0), ("d", 1),
                                           ("e f g", 1)])]
    records += [dict(kind="phoneme", start=10. + k, duration=0.1,
                     sequence_id=s, word_index=float(w))
                for k, (s, w) in enumerate([(0, 0), (0, 0), (0, 1), (1, 0)])]
    want = jevents.extract_sequence_info(pd.DataFrame(records))
    got = events.extract_sequence_info(
        events.EventTable.from_records(records))
    _frame_columns_equal(want, got)
    assert got["word_index"].tolist()[:4] == [0, 2, 0, 1]
    with pytest.raises(ValueError, match="one word sequence"):
        events.extract_sequence_info(events.EventTable.from_records(
            [dict(r, sequence_id=0) for r in records[:4]]))


def test_scale_reject_equals_the_jax_packages(study):
    """The host normalize + clamp + reject of one batch, with the scalers
    fitted on the same epochs."""
    jset = study.jax.train.datasets
    kwargs = dict(n_samples_per_recording=20, n_samples_features=100)
    jscaler = jnorm.BatchScaler(jset[0].features, **kwargs).fit(jset)
    scaler = norm.BatchScaler(jset[0].features, **kwargs).fit(jset)
    batch = study.jax.train.get_batch(np.arange(0, 40, 3))
    # the limit at the median row's peak: about half the rows past it
    peaks = np.abs(jscaler.transform(batch).meg).reshape(len(batch), -1)
    limit = float(np.median(peaks.max(-1)))
    rejected = {}
    for clip in (False, True):
        want, want_keep = jnorm.ScaleReject(jscaler, limit, True,
                                            clip)(batch)
        got, keep = norm.ScaleReject(scaler, limit, True, clip)(batch)
        np.testing.assert_array_equal(keep, want_keep)
        np.testing.assert_allclose(got.meg, want.meg, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.features, want.features, rtol=1e-6,
                                   atol=1e-6)
        rejected[clip] = int((~keep).sum())
    # a clamped batch keeps every row its features mask does not empty
    assert 0 < rejected[False] < len(keep) and rejected[True] == 0
    back = scaler.inverse_transform(scaler.transform(batch))
    np.testing.assert_allclose(back.meg, batch.meg, rtol=1e-4, atol=1e-4)


def test_memory_cache_computes_once():
    calls = []

    def compute(x, y=1):
        calls.append((x, y))
        return x + y
    first = cache.MemoryCache("test_torch_data", dict(k=1))
    assert first.get(compute, 2, y=3) == 5
    assert cache.MemoryCache("test_torch_data", dict(k=1)).get(
        compute, 2, y=3) == 5
    assert cache.MemoryCache("test_torch_data", dict(k=2)).get(
        compute, 2, y=3) == 5
    assert calls == [(2, 3), (2, 3)]


def _event_rows(event_list):
    return [(e.kind, e.start, e.duration) for e in event_list]


def test_event_lists_equal_the_jax_packages(study):
    """``get_batch(with_events=True)`` across recordings and a segment's
    ``__getitem__``: each window's DataSlice marker, then its events,
    the same kinds, starts and durations."""
    jtest, ptest = study.jax.test, study.port.test
    indices = np.array([0, len(jtest) - 1, 3])
    want = jtest.get_batch(indices, with_events=True)._event_lists
    got = ptest.get_batch(indices, with_events=True)._event_lists
    assert len(got) == len(want) == 3
    for got_list, want_list in zip(got, want):
        assert got_list[0].kind == "dataslice" and len(got_list) > 1
        assert _event_rows(got_list) == _event_rows(want_list)
    assert _event_rows(ptest[5]._event_lists[0]) \
        == _event_rows(jtest[5]._event_lists[0])
    assert ptest.get_batch(indices)._event_lists == []
