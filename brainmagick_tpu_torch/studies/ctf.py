"""CTF MEG ``.ds`` directories (res4 header + meg4 samples): reader and
writer.

Port of ``brainmagick_tpu/studies/ctf.py`` (MOUS, the schoffelen2019
release, ships its raws as ``.ds``).

``<name>.ds/<name>.res4``, big-endian: the magic ``MEG41RS\\x00``; the
general resources (the general setup record starts at byte 1288:
no_samples i4, no_channels i2, sample_rate f8, epoch_time f8, no_trials
i2, preTrigPts i4, ...); the file setup at byte 1836 (run_name 32,
run_title 256, instruments 32, collect_descriptor 32, subject_id 32,
operator 32, sensor_file_name 60, pad 4, run-description size i4 and its
text); the filters (count i2, each freq f8, class i4, type i4, n_params
i2, n_params x f8); the channel names (32 bytes each); then one 1328-byte
sensor record per channel (type/run i2 x 2, coil_shape i4,
proper/q/io gains and io offset f8 x 4, num_coils i2, grad_order i2, pad
4, 8 device-frame and 8 head-frame coil records of 80 bytes).

``<name>.ds/<name>.meg4`` (continued in ``<name>.1_meg4``, ...): the
magic ``MEG41CP\\x00``, then i4 big-endian samples [trial, channel,
sample]; a continuous recording is its trials end to end.

Stored integers divide by proper_gain * q_gain for MEG and reference
sensors, q_gain * io_gain for EEG, q_gain otherwise. Software gradient
compensation is not re-applied.
"""

from __future__ import annotations

import struct
import typing as tp
from pathlib import Path

import numpy as np

from .api import INVALID_POSITION, RawData
from .io import FIFFV_EEG_CH, FIFFV_MEG_CH, FIFFV_STIM_CH

RES4_MAGIC = b"MEG41RS\x00"
MEG4_MAGIC = b"MEG41CP\x00"

# -- res4 fixed offsets (bytes) ---------------------------------------------
OFF_APP_NAME = 8
OFF_GENERAL_SETUP = 1288      # = 8 + 3*256 + 2 + 2*255
OFF_NO_SAMPLES = 1288         # i4
OFF_NO_CHANNELS = 1292        # i2 (+2 pad)
OFF_SAMPLE_RATE = 1296        # f8
OFF_EPOCH_TIME = 1304         # f8
OFF_NO_TRIALS = 1312          # i2 (+2 pad)
OFF_PRE_TRIG_PTS = 1316       # i4
OFF_NO_TRIALS_DONE = 1320     # i2
OFF_NO_TRIALS_DISPLAY = 1322  # i2
OFF_SAVE_TRIALS = 1324        # i4
OFF_FILE_SETUP = 1836         # run_name starts here
OFF_RUN_DESC_SIZE = 2316      # i4; = 1836 + 32+256+32+32+32+32+60 + 4 pad
OFF_VARIABLE = 2320           # run description text starts here

SENSOR_TYPE_REF_MAG = 0
SENSOR_TYPE_REF_GRAD = 1
SENSOR_TYPE_MEG = 5
SENSOR_TYPE_EEG = 9
SENSOR_TYPE_STIM = 11
SENSOR_TYPE_ADC = 18

# channel kinds follow the package-wide FIFF convention (studies/io.py)
KIND_OTHER = 0
KIND_MEG = FIFFV_MEG_CH
KIND_EEG = FIFFV_EEG_CH
KIND_STIM = FIFFV_STIM_CH

_COIL_DTYPE = np.dtype([
    ("pos", ">f8", 3), ("_pad0", ">f8"),
    ("orient", ">f8", 3), ("_pad1", ">f8"),
    ("num_turns", ">i2"), ("_pad2", "V6"), ("area", ">f8"),
])  # 80 bytes

_SENSOR_DTYPE = np.dtype([
    ("sensor_type", ">i2"), ("original_run", ">i2"), ("coil_shape", ">i4"),
    ("proper_gain", ">f8"), ("q_gain", ">f8"), ("io_gain", ">f8"),
    ("io_offset", ">f8"), ("num_coils", ">i2"), ("grad_order", ">i2"),
    ("_pad0", ">i4"),
    ("coils", _COIL_DTYPE, 8), ("head_coils", _COIL_DTYPE, 8),
])  # 1328 bytes
assert _COIL_DTYPE.itemsize == 80
assert _SENSOR_DTYPE.itemsize == 1328


class Res4(tp.NamedTuple):
    no_samples: int          # per trial
    no_channels: int
    sample_rate: float
    no_trials: int
    pre_trig_pts: int
    run_name: str
    subject_id: str
    ch_names: tp.List[str]
    sensors: np.ndarray      # structured [_SENSOR_DTYPE] * no_channels


def _ctf_member(ds_path: Path, ext: str) -> Path:
    """`X.ds` members are named `X.<ext>` inside the directory."""
    return ds_path / (ds_path.name[:-len(".ds")] + "." + ext)


def _cstr(raw: bytes) -> str:
    return raw.split(b"\x00")[0].decode("latin1")


def read_res4(path: tp.Union[str, Path]) -> Res4:
    buf = Path(path).read_bytes()
    if buf[:8] != RES4_MAGIC:
        raise ValueError(f"{path}: bad res4 magic {buf[:8]!r}")

    def i2(off: int) -> int:
        return struct.unpack_from(">h", buf, off)[0]

    def i4(off: int) -> int:
        return struct.unpack_from(">i", buf, off)[0]

    def f8(off: int) -> float:
        return struct.unpack_from(">d", buf, off)[0]

    no_samples = i4(OFF_NO_SAMPLES)
    no_channels = i2(OFF_NO_CHANNELS)
    sample_rate = f8(OFF_SAMPLE_RATE)
    no_trials = i2(OFF_NO_TRIALS)
    pre_trig_pts = i4(OFF_PRE_TRIG_PTS)
    run_name = _cstr(buf[OFF_FILE_SETUP:OFF_FILE_SETUP + 32])
    # file setup: run_name 32 + run_title 256 + instruments 32 +
    # collect_descriptor 32 = 352 -> subject_id, then operator at +384
    subject_id = _cstr(buf[OFF_FILE_SETUP + 352:OFF_FILE_SETUP + 384])
    if not (0 < no_channels < 10000 and 0 < no_samples and
            0 < sample_rate < 1e6):
        raise ValueError(
            f"{path}: implausible res4 header (nchan={no_channels}, "
            f"nsamp={no_samples}, sfreq={sample_rate}); the layout "
            "anchors in studies/ctf.py may need adjusting for this file")

    pos = OFF_RUN_DESC_SIZE
    run_desc_size = i4(pos)
    pos = OFF_VARIABLE + run_desc_size
    n_filters = i2(pos)
    pos += 2
    for _ in range(n_filters):
        # freq f8, class i4, type i4, n_params i2, params f8 each
        n_params = i2(pos + 16)
        pos += 18 + 8 * n_params

    ch_names = [_cstr(buf[pos + 32 * k: pos + 32 * (k + 1)])
                for k in range(no_channels)]
    pos += 32 * no_channels
    sensors = np.frombuffer(
        buf, _SENSOR_DTYPE, count=no_channels, offset=pos).copy()
    return Res4(no_samples=no_samples, no_channels=no_channels,
                sample_rate=sample_rate, no_trials=no_trials,
                pre_trig_pts=pre_trig_pts, run_name=run_name,
                subject_id=subject_id, ch_names=ch_names, sensors=sensors)


def _meg4_files(ds_path: Path) -> tp.List[Path]:
    first = _ctf_member(ds_path, "meg4")
    files = [first]
    k = 1
    while (nxt := _ctf_member(ds_path, f"{k}_meg4")).exists():
        files.append(nxt)
        k += 1
    return files


def _channel_cal(sensors: np.ndarray) -> np.ndarray:
    """Multiplier from stored int to physical units, per channel."""
    stype = sensors["sensor_type"]
    proper = np.where(sensors["proper_gain"] != 0,
                      sensors["proper_gain"], 1.0)
    q = np.where(sensors["q_gain"] != 0, sensors["q_gain"], 1.0)
    io = np.where(sensors["io_gain"] != 0, sensors["io_gain"], 1.0)
    meg_like = np.isin(stype, (SENSOR_TYPE_REF_MAG, SENSOR_TYPE_REF_GRAD,
                               SENSOR_TYPE_MEG))
    cal = np.where(meg_like, 1.0 / (proper * q),
                   np.where(stype == SENSOR_TYPE_EEG, 1.0 / (q * io),
                            1.0 / q))
    return cal.astype(np.float64)


def _kinds(sensors: np.ndarray) -> tp.List[int]:
    mapping = {SENSOR_TYPE_MEG: KIND_MEG, SENSOR_TYPE_EEG: KIND_EEG,
               SENSOR_TYPE_STIM: KIND_STIM}
    return [mapping.get(int(t), KIND_OTHER)
            for t in sensors["sensor_type"]]


def _positions(sensors: np.ndarray) -> np.ndarray:
    """Normalized 2D layout from head-coordinate coil positions (the
    mne.find_layout role, same projection as studies/io.py)."""
    from .io import _positions_from_locs
    pos3 = sensors["head_coils"]["pos"][:, 0, :]  # first coil, [C, 3]
    # only spatial sensor types get a layout position
    spatial = np.isin(sensors["sensor_type"],
                      (SENSOR_TYPE_MEG, SENSOR_TYPE_EEG))
    locs = np.where(spatial[:, None], pos3, 0.0).astype(np.float32)
    out = _positions_from_locs(locs)
    out[~spatial] = INVALID_POSITION
    return out


def read_ctf(path: tp.Union[str, Path]) -> RawData:
    """Read a CTF .ds directory into RawData (all channels, physical
    units, FIFF-style ch_kinds, normalized 2D positions)."""
    ds_path = Path(path)
    if not ds_path.is_dir():
        raise ValueError(f"{ds_path} is not a .ds directory")
    res4 = read_res4(_ctf_member(ds_path, "res4"))

    nchan, nsamp = res4.no_channels, res4.no_samples
    trial_bytes = 4 * nchan * nsamp

    # validate the trial accounting up front so mismatches get a real
    # diagnostic instead of a broadcast error / silently dropped bytes
    files = _meg4_files(ds_path)
    bodies = []
    file_trials = []
    for fname in files:
        raw_bytes = fname.read_bytes()
        if raw_bytes[:8] != MEG4_MAGIC:
            raise ValueError(f"{fname}: bad meg4 magic {raw_bytes[:8]!r}")
        body = raw_bytes[8:]
        n_trials, leftover = divmod(len(body), trial_bytes)
        if leftover:
            raise ValueError(
                f"{fname}: {leftover} trailing bytes do not form a whole "
                f"[{nchan} x {nsamp}] trial — truncated or corrupt file")
        bodies.append(body)
        file_trials.append(n_trials)
    if sum(file_trials) != res4.no_trials:
        raise ValueError(
            f"{ds_path}: meg4 files hold {sum(file_trials)} trials "
            f"({file_trials} per file), res4 promises {res4.no_trials}")

    total = res4.no_trials * nsamp
    data = np.empty((nchan, total), dtype=np.float32)
    t = 0
    for body, n_trials in zip(bodies, file_trials):
        trials = np.frombuffer(
            body, ">i4", count=n_trials * nchan * nsamp
        ).reshape(n_trials, nchan, nsamp)
        # [n, C, S] -> [C, n*S]
        chunk = trials.transpose(1, 0, 2).reshape(nchan, -1)
        data[:, t:t + chunk.shape[1]] = chunk
        t += chunk.shape[1]
    data *= _channel_cal(res4.sensors).astype(np.float32)[:, None]
    return RawData(data=data, sample_rate=res4.sample_rate,
                   ch_names=list(res4.ch_names),
                   positions=_positions(res4.sensors),
                   ch_kinds=_kinds(res4.sensors))


# -- writer (tests / interchange) --------------------------------------------

def write_ctf(path: tp.Union[str, Path], raw: RawData,
              proper_gain: float = 1e9, q_gain: float = 2 ** 20,
              trial_samples: int = 0,
              run_name: str = "synthetic") -> None:
    """Write RawData as a .ds directory (res4 + meg4). Values are
    quantized to ints via the same gains the reader divides by; MEG
    channels get proper_gain*q_gain, EEG io-gain paths, stim unity."""
    ds_path = Path(path)
    assert ds_path.suffix == ".ds", ds_path
    ds_path.mkdir(parents=True, exist_ok=True)
    kinds = raw.ch_kinds or [KIND_MEG] * raw.n_channels
    nchan, total = raw.data.shape
    trial_samples = trial_samples or total
    assert total % trial_samples == 0, "pad data to whole trials"
    n_trials = total // trial_samples

    # --- sensors table
    sensors = np.zeros(nchan, dtype=_SENSOR_DTYPE)
    type_of = {KIND_MEG: SENSOR_TYPE_MEG, KIND_EEG: SENSOR_TYPE_EEG,
               KIND_STIM: SENSOR_TYPE_STIM, KIND_OTHER: SENSOR_TYPE_ADC}
    for k, kind in enumerate(kinds):
        sensors["sensor_type"][k] = type_of.get(kind, SENSOR_TYPE_ADC)
        sensors["q_gain"][k] = q_gain if kind == KIND_MEG else 1.0
        sensors["proper_gain"][k] = proper_gain if kind == KIND_MEG else 1.0
        sensors["io_gain"][k] = 1.0
        sensors["num_coils"][k] = 1
        px, py = raw.positions[k]
        if px != INVALID_POSITION and kind in (KIND_MEG, KIND_EEG):
            # embed the normalized layout on a unit hemisphere so the
            # azimuthal read-back projection recovers it monotonically
            sensors["head_coils"]["pos"][k, 0] = (px - 0.5, py - 0.5, 0.5)

    # --- res4
    header = bytearray(OFF_VARIABLE)
    header[:8] = RES4_MAGIC
    header[OFF_APP_NAME:OFF_APP_NAME + 16] = b"brainmagick_tpu\x00"
    struct.pack_into(">i", header, OFF_NO_SAMPLES, trial_samples)
    struct.pack_into(">h", header, OFF_NO_CHANNELS, nchan)
    struct.pack_into(">d", header, OFF_SAMPLE_RATE, float(raw.sample_rate))
    struct.pack_into(">d", header, OFF_EPOCH_TIME,
                     trial_samples / float(raw.sample_rate))
    struct.pack_into(">h", header, OFF_NO_TRIALS, n_trials)
    struct.pack_into(">h", header, OFF_NO_TRIALS_DONE, n_trials)
    struct.pack_into(">i", header, OFF_SAVE_TRIALS, 1)
    name_b = run_name.encode("latin1")[:31]
    header[OFF_FILE_SETUP:OFF_FILE_SETUP + len(name_b)] = name_b
    struct.pack_into(">i", header, OFF_RUN_DESC_SIZE, 0)

    chunks = [bytes(header), struct.pack(">h", 0)]  # no filters
    for name in raw.ch_names:
        chunks.append(name.encode("latin1")[:31].ljust(32, b"\x00"))
    chunks.append(sensors.tobytes())
    _ctf_member(ds_path, "res4").write_bytes(b"".join(chunks))

    # --- meg4
    cal = _channel_cal(sensors)  # int -> physical; invert to quantize
    ints = np.rint(np.asarray(raw.data, dtype=np.float64)
                   / cal[:, None]).astype(">i4")
    trials = ints.reshape(nchan, n_trials, trial_samples).transpose(1, 0, 2)
    _ctf_member(ds_path, "meg4").write_bytes(
        MEG4_MAGIC + trials.tobytes())
