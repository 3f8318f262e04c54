"""The port's file readers and writers against the JAX package's: FIF, KIT
``.con``, CTF ``.ds`` and TextGrid, each file written by one package and
read by the other (data, channel names and kinds, positions and sample
rate bit-equal), the committed layout hashes, the refusals of broken
files, the Levenshtein alignment, and the pandas-free CSV reader against
``pd.read_csv``."""

import hashlib
import io
import random
import struct
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from test_ctf import _mixed_raw as ctf_mixed_raw
from test_kit import _mixed_raw as kit_mixed_raw
from test_schoffelen2019 import _write_textgrid

from brainmagick_tpu import textgrid as jtextgrid
from brainmagick_tpu.studies import api as japi
from brainmagick_tpu.studies import ctf as jctf
from brainmagick_tpu.studies import io as jio
from brainmagick_tpu.studies import kit as jkit
from brainmagick_tpu.studies import utils as jutils
from brainmagick_tpu.studies.fake import grid_positions
from brainmagick_tpu_torch import textgrid
from brainmagick_tpu_torch.studies import api, ctf
from brainmagick_tpu_torch.studies import io as fif
from brainmagick_tpu_torch.studies import kit, utils

GOLDEN = Path(__file__).parent / "golden"
#: (writer, reader) package pairs: port -> JAX and JAX -> port
DIRECTIONS = ["port_to_jax", "jax_to_port"]


def _raws(data, sample_rate, ch_names, positions, ch_kinds):
    """The same recording as the port's RawData and the JAX package's."""
    kwargs = dict(data=data, sample_rate=sample_rate, ch_names=ch_names,
                  positions=positions, ch_kinds=ch_kinds)
    return api.RawData(**kwargs), japi.RawData(**kwargs)


def _assert_raw_equal(got, want) -> None:
    assert type(got).__module__ != type(want).__module__
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype == np.float32
    assert got.ch_names == want.ch_names
    assert got.ch_kinds == want.ch_kinds
    np.testing.assert_array_equal(got.positions, want.positions)
    assert got.sample_rate == want.sample_rate


def _pair(direction, port_module, jax_module):
    """(writer module, raw index, reader module) of `direction`."""
    if direction == "port_to_jax":
        return port_module, 0, jax_module
    return jax_module, 1, port_module


def _meg_raws(n_meg=10, n_times=2000, sfreq=1000.0, seed=0, scale=1e-13):
    rng = np.random.RandomState(seed)
    meg = rng.randn(n_meg, n_times).astype(np.float32) * scale
    stim = np.zeros((1, n_times), dtype=np.float32)
    stim[0, 300:400] = 20.
    misc = rng.randn(1, n_times).astype(np.float32) * 0.1
    positions = np.concatenate(
        [grid_positions(n_meg), [[-0.1, -0.1]] * 2]).astype(np.float32)
    return _raws(np.concatenate([meg, stim, misc]), sfreq,
                 [f"MEG {k:03d}" for k in range(n_meg)]
                 + ["STI 014", "MISC 011"], positions,
                 [1] * n_meg + [3, 0])


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_fif_both_ways(tmp_path, direction):
    raws = _meg_raws(scale=1.)
    writer, k, reader = _pair(direction, fif, jio)
    path = tmp_path / "raw.fif"
    writer.write_fif(path, raws[k], buffer_samples=700)
    got = fif.read_fif(path)
    want = jio.read_fif(path)
    _assert_raw_equal(got, want)
    np.testing.assert_array_equal(got.data, raws[0].data)
    assert reader.read_fif(path).ch_names == raws[0].ch_names


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_kit_both_ways(tmp_path, direction):
    raws = _meg_raws()
    writer, k, _ = _pair(direction, kit, jkit)
    path = tmp_path / "x.con"
    writer.write_kit(path, raws[k], system_name="NYU 208ch")
    _assert_raw_equal(kit.read_kit(path), jkit.read_kit(path))
    assert kit.read_con_info(path)._asdict().keys() \
        == jkit.read_con_info(path)._asdict().keys()
    for (name, got), want in zip(kit.read_con_info(path)._asdict().items(),
                                 jkit.read_con_info(path)):
        np.testing.assert_array_equal(got, want, err_msg=name)
    # int16 quantization: one step of 5 V / 2^16 x 1e-12 T/V
    np.testing.assert_allclose(kit.read_kit(path).data[:10],
                               raws[0].data[:10], atol=8e-17)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("n_files", [1, 3])
def test_ctf_both_ways(tmp_path, direction, n_files):
    """A .ds of 4 trials, in one .meg4 or split over continuation files."""
    rng = np.random.RandomState(1)
    n_meg, n_times = 9, 4000
    stim = np.zeros((1, n_times), dtype=np.float32)
    stim[0, 500:800] = 20
    raws = _raws(
        np.concatenate([rng.randn(n_meg, n_times).astype(np.float32)
                        * 1e-12, rng.randn(1, n_times).astype(np.float32)
                        * 1e-5, stim, rng.randn(1, n_times)
                        .astype(np.float32)]), 1200.0,
        [f"MLC{k:02d}-4304" for k in range(n_meg)]
        + ["EEG001", "UPPT001", "UADC001"],
        np.concatenate([grid_positions(n_meg + 1), [[-0.1, -0.1]] * 2]
                       ).astype(np.float32),
        [ctf.KIND_MEG] * n_meg + [ctf.KIND_EEG, ctf.KIND_STIM,
                                  ctf.KIND_OTHER])
    writer, k, _ = _pair(direction, ctf, jctf)
    ds = tmp_path / "run.ds"
    writer.write_ctf(ds, raws[k], trial_samples=1000, run_name="run-07")
    if n_files > 1:
        meg4 = ds / "run.meg4"
        body = meg4.read_bytes()
        trial = (len(body) - 8) // 4
        meg4.write_bytes(body[:8 + trial])
        (ds / "run.1_meg4").write_bytes(ctf.MEG4_MAGIC
                                        + body[8 + trial:8 + 2 * trial])
        (ds / "run.2_meg4").write_bytes(ctf.MEG4_MAGIC
                                        + body[8 + 2 * trial:])
    _assert_raw_equal(ctf.read_ctf(ds), jctf.read_ctf(ds))
    got, want = ctf.read_res4(ds / "run.res4"), jctf.read_res4(ds
                                                               / "run.res4")
    for name, value in got._asdict().items():
        if name == "sensors":
            assert value.tobytes() == want.sensors.tobytes()
        else:
            assert value == getattr(want, name), name
    assert got.run_name == "run-07" and got.no_trials == 4
    np.testing.assert_array_equal(ctf.read_ctf(ds).data[10],
                                  raws[0].data[10])


def _port_raw(raw) -> api.RawData:
    return api.RawData(data=raw.data, sample_rate=raw.sample_rate,
                       ch_names=raw.ch_names, positions=raw.positions,
                       ch_kinds=raw.ch_kinds)


def test_writers_reproduce_the_layout_hashes(tmp_path):
    """tests/golden/kit_golden.txt and ctf_golden.txt, from the port's
    writers on tests/test_kit.py's and tests/test_ctf.py's inputs."""
    raw = _port_raw(kit_mixed_raw(n_meg=3, n_times=50, seed=42))
    kit.write_kit(tmp_path / "golden.con", raw)
    assert hashlib.sha256((tmp_path / "golden.con").read_bytes()
                          ).hexdigest() \
        == (GOLDEN / "kit_golden.txt").read_text().strip()
    raw = _port_raw(ctf_mixed_raw(n_meg=3, n_times=100, seed=42))
    ds = tmp_path / "golden.ds"
    ctf.write_ctf(ds, raw, trial_samples=50, run_name="golden")
    assert hashlib.sha256((ds / "golden.res4").read_bytes()
                          + (ds / "golden.meg4").read_bytes()
                          ).hexdigest() \
        == (GOLDEN / "ctf_golden.txt").read_text().strip()


def _refusal(fn, path):
    """The exception type and message of fn(path)."""
    with pytest.raises(Exception) as info:
        fn(path)
    return type(info.value).__name__, str(info.value)


def test_ctf_refusals_match(tmp_path):
    """A truncated .meg4 (half a trial, a whole trial missing, one too
    many) and a bad res4 magic: the same exception and message."""
    raw = _meg_raws(n_times=2000)[0]
    raw.ch_kinds = [ctf.KIND_MEG] * 10 + [ctf.KIND_STIM, ctf.KIND_OTHER]
    ds = tmp_path / "trunc.ds"
    ctf.write_ctf(ds, raw, trial_samples=1000)
    meg4 = ds / "trunc.meg4"
    body = meg4.read_bytes()
    trial_bytes = 4 * 12 * 1000
    for cut, match in ((body[:len(body) - 1000], "trailing bytes"),
                       (body[:8 + trial_bytes], "1 trials.*promises 2"),
                       (body + body[8:8 + trial_bytes],
                        "3 trials.*promises 2")):
        meg4.write_bytes(cut)
        got = _refusal(ctf.read_ctf, ds)
        assert got == _refusal(jctf.read_ctf, ds)
        assert got[0] == "ValueError"
        with pytest.raises(ValueError, match=match):
            ctf.read_ctf(ds)
    bad = tmp_path / "x.res4"
    bad.write_bytes(b"NOTMEG4\x00" + b"\x00" * 4000)
    assert _refusal(ctf.read_res4, bad) == _refusal(jctf.read_res4, bad)
    with pytest.raises(ValueError, match="magic"):
        ctf.read_res4(bad)


def test_kit_and_fif_refusals_match(tmp_path):
    """A non-continuous .con, an unknown amplifier code, and a FIF file
    without measurement info."""
    con = tmp_path / "x.con"
    kit.write_kit(con, _meg_raws(n_times=100)[0])
    buf = bytearray(con.read_bytes())
    acq = struct.unpack_from("<i", buf, kit.SLOT_ACQ)[0]
    struct.pack_into("<i", buf, acq, 2)  # evoked
    con.write_bytes(bytes(buf))
    assert _refusal(kit.read_kit, con) == _refusal(jkit.read_kit, con)
    with pytest.raises(ValueError, match="continuous"):
        kit.read_kit(con)
    struct.pack_into("<i", buf, acq, 1)
    amp = struct.unpack_from("<i", buf, kit.SLOT_AMPLIFIER)[0]
    struct.pack_into("<i", buf, amp, 99)
    con.write_bytes(bytes(buf))
    assert _refusal(kit.read_kit, con) == _refusal(jkit.read_kit, con)
    bad = tmp_path / "bad.fif"
    bad.write_bytes(b"\x00" * 64)
    assert _refusal(fif.read_fif, bad) == _refusal(jio.read_fif, bad)


def test_find_events_equal(tmp_path):
    rng = np.random.RandomState(3)
    stim = np.zeros(5000, dtype=np.float32)
    for start in np.sort(rng.choice(4900, 40, replace=False)):
        stim[start:start + rng.randint(1, 60)] = rng.choice([5, 10, 20])
    for shortest in (1, 3):
        np.testing.assert_array_equal(
            fif.find_events(stim, shortest),
            jio.find_events(stim, shortest))


def _write_short_textgrid(path: Path) -> None:
    path.write_text("\n".join([
        'File type = "ooTextFile short"', '"TextGrid"', "", "0", "1.5",
        "<exists>", "2", '"IntervalTier"', '"ORT-MAU"', "0", "1.5", "2",
        "0", "0.7", '"hallo"', "0.7", "1.5", '"wereld"',
        '"IntervalTier"', '"MAU"', "0", "1.5", "3", "0", "0.3", '"h"',
        "0.3", "0.7", '"A"', "0.7", "1.5", '"<p:>"']))


@pytest.mark.parametrize("form", ["long", "short"])
def test_textgrid_equal(tmp_path, form):
    """Both readers on the same files, in each format."""
    path = tmp_path / "x.TextGrid"
    if form == "long":
        _write_textgrid(path, "zij zingt elke ochtend vroeg in de tuin")
    else:
        _write_short_textgrid(path)
    got, want = textgrid.read_textgrid(path), jtextgrid.read_textgrid(path)
    assert len(got) > 3
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert {k: [vars(e) for e in v]
            for k, v in textgrid.textgrid_to_dict(path).items()} \
        == {k: [vars(e) for e in v]
            for k, v in jtextgrid.textgrid_to_dict(path).items()}


@pytest.mark.parametrize("seed", range(4))
def test_match_list_equal(seed):
    """Random sequences over a small alphabet (many ties), with
    insertions and deletions."""
    rng = random.Random(seed)
    a = [rng.choice("abcde") for _ in range(rng.randint(0, 60))]
    b = [x for x in a if rng.random() > 0.2]
    b = [x if rng.random() > 0.1 else rng.choice("abcdef") for x in b]
    for _ in range(rng.randint(0, 8)):
        b.insert(rng.randint(0, len(b)), rng.choice("xyz"))
    for first, second in ((a, b), (b, a), ([True, False] * 9, b[:20])):
        got = utils.match_list(first, second)
        want = jutils.match_list(first, second)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_read_csv_types_as_pandas(tmp_path):
    """utils.read_csv against pd.read_csv: ints, floats that differ from
    float() in the last bit, missing cells, bools and strings, both
    separators."""
    rng = np.random.RandomState(0)
    n = 400
    onset = np.cumsum(np.full(n, 0.4))
    table = {
        "onset": [repr(float(x)) for x in onset],
        "ints": [str(k) for k in range(n)],
        "ints_missing": ["" if k % 7 == 0 else str(k) for k in range(n)],
        "floats": [repr(float(x)) for x in rng.randn(n) * 10.
                   ** rng.randint(-20, 20, n)],
        "flags": ["True" if k % 3 else "False" for k in range(n)],
        "words": [rng.choice(["the", "cat", "NA", "", "1a"])
                  for _ in range(n)],
        "trial_type": [repr(dict(kind="word", word="it's"))] * n,
    }
    for sep in (",", "\t"):
        path = tmp_path / f"t{len(sep)}.csv"
        text = sep.join(table) + "\n" + "\n".join(
            sep.join(f'"{table[c][k]}"' if sep in table[c][k]
                     or '"' in table[c][k] else table[c][k]
                     for c in table) for k in range(n)) + "\n"
        path.write_text(text)
        want = pd.read_csv(path, sep=sep)
        got = utils.read_csv(path, sep=sep)
        assert len(got) == len(want) == n
        assert list(got[0]) == list(want.columns)
        for name in want.columns:
            column = want[name].to_numpy()
            values = [row[name] for row in got]
            if column.dtype.kind in "fi":
                np.testing.assert_array_equal(
                    np.asarray(values, dtype=column.dtype), column,
                    err_msg=name)
            else:
                expected = [None if isinstance(v, float) and np.isnan(v)
                            else v for v in column.tolist()]
                assert [None if isinstance(v, float) and np.isnan(v)
                        else v for v in values] == expected, name
    assert sum(float(v) != utils.parse_float(v) for v in table["onset"]) > 0


def test_parse_float_is_pandas_parser():
    rng = random.Random(0)
    words = [repr(rng.uniform(-1, 1) * 10 ** rng.randint(-310, 308))
             for _ in range(3000)]
    words += ["1e-320", "5.", ".5", "  7 ", "-0.0", "1E5", "+3.25",
              "123456789012345678901234"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(words)))["x"]
    got = np.array([utils.parse_float(w) for w in words])
    np.testing.assert_array_equal(got, want.to_numpy())
