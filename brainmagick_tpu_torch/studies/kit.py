"""KIT/Yokogawa ``.con`` (SQD) continuous files: reader and writer.

Port of ``brainmagick_tpu/studies/kit.py`` (MEG-MASC, the gwilliams2022
release, ships its raws as ``.con``). Little-endian throughout:

  * a pointer table of i4 block offsets at fixed slots: 16 basic info,
    64 channel info (+ record size i4 at 68), 96 sensitivity, 112
    amplifier, 128 acquisition parameters, 144 raw data;
  * basic info: version i4, revision i4, system_id i4, system_name 128s,
    model_name 128s, channel_count i4, comment 256s;
  * channel info: fixed-size records starting with type i4; MEG channels
    carry x/y/z (m) f8, then theta/phi (deg), coil size and baseline f8.
    Types 1/2/3 are magnetometer/axial/planar gradiometer, 0x100|k a
    reference sensor, 0x200 a trigger, the rest misc;
  * sensitivity: per channel offset f8 + gain f8 (T/V for MEG);
  * amplifier: gain code i4 (``AMP_GAINS``);
  * acquisition: type i4 (1 = continuous), sample_rate f8, sample_count
    i4, actual_sample_count i4;
  * raw data: int16 samples [sample, channel]; physical value = counts *
    (input_range / 2^adc_bits) / amp_gain * sens_gain.
"""

from __future__ import annotations

import struct
import typing as tp
from pathlib import Path

import numpy as np

from .api import INVALID_POSITION, RawData
from .io import FIFFV_EEG_CH, FIFFV_MEG_CH, FIFFV_STIM_CH

# -- pointer slots ------------------------------------------------------------
SLOT_BASIC = 16
SLOT_CHANNELS = 64       # + record size i4 at 68
SLOT_SENSITIVITY = 96
SLOT_AMPLIFIER = 112
SLOT_ACQ = 128
SLOT_DATA = 144

# -- channel types (Yokogawa enumeration) -------------------------------------
CH_NULL = 0
CH_MAGNETOMETER = 1
CH_AXIAL_GRADIOMETER = 2
CH_PLANAR_GRADIOMETER = 3
CH_REFERENCE_MARK = 0x100    # | sensor type
CH_TRIGGER = 0x200
CH_EEG = 0x300
CH_ECG = 0x400
CH_ETC = 0x500

MEG_TYPES = (CH_MAGNETOMETER, CH_AXIAL_GRADIOMETER, CH_PLANAR_GRADIOMETER)

ACQ_CONTINUOUS = 1

# ADC characteristics (KIT-NYU defaults; fields of the conversion, not
# of the file): counts span input_range volts over 2^adc_bits codes.
ADC_BITS = 16
INPUT_RANGE_VOLTS = 5.0
# amplifier gain codes -> multiplier; real systems encode input/output
# gain stages in bit fields of this i4 — extend the map as needed
AMP_GAINS = {0: 1.0, 1: 2.0, 2: 5.0, 3: 10.0, 4: 20.0, 5: 50.0,
             6: 100.0, 7: 200.0}

CHAN_RECORD_SIZE = 80

# channel kinds follow the package-wide FIFF convention (studies/io.py)
KIND_OTHER = 0
KIND_MEG = FIFFV_MEG_CH
KIND_EEG = FIFFV_EEG_CH
KIND_STIM = FIFFV_STIM_CH


class ConInfo(tp.NamedTuple):
    system_name: str
    channel_count: int
    sample_rate: float
    sample_count: int
    ch_types: np.ndarray        # [C] int
    ch_pos3: np.ndarray         # [C, 3] float (m)
    sens_gain: np.ndarray       # [C] float (T/V for MEG)
    amp_gain: float
    data_offset: int


def _kind_of(ch_type: int) -> int:
    if ch_type in MEG_TYPES:
        return KIND_MEG
    family = ch_type & 0xF00
    if family == CH_TRIGGER:
        return KIND_STIM
    if family == CH_EEG:
        return KIND_EEG
    return KIND_OTHER


def read_con_info(path: tp.Union[str, Path]) -> ConInfo:
    buf = Path(path).read_bytes()

    def i4(off: int) -> int:
        return struct.unpack_from("<i", buf, off)[0]

    def f8(off: int) -> float:
        return struct.unpack_from("<d", buf, off)[0]

    basic = i4(SLOT_BASIC)
    nchan = i4(basic + 268)
    system_name = buf[basic + 12:basic + 140].split(b"\x00")[0] \
        .decode("latin1")

    chan_offset = i4(SLOT_CHANNELS)
    chan_size = i4(SLOT_CHANNELS + 4) or CHAN_RECORD_SIZE
    ch_types = np.empty(nchan, dtype=np.int64)
    ch_pos3 = np.zeros((nchan, 3), dtype=np.float64)
    for k in range(nchan):
        base = chan_offset + k * chan_size
        ch_types[k] = i4(base)
        if ch_types[k] in MEG_TYPES:
            ch_pos3[k] = [f8(base + 4), f8(base + 12), f8(base + 20)]

    sens_offset = i4(SLOT_SENSITIVITY)
    sens_gain = np.array(
        [f8(sens_offset + 16 * k + 8) for k in range(nchan)])
    sens_gain = np.where(sens_gain != 0, sens_gain, 1.0)

    amp_code = i4(i4(SLOT_AMPLIFIER))
    if amp_code not in AMP_GAINS:
        raise ValueError(f"{path}: unknown amplifier gain code "
                         f"{amp_code}; extend studies/kit.py AMP_GAINS")

    acq = i4(SLOT_ACQ)
    acq_type = i4(acq)
    if acq_type != ACQ_CONTINUOUS:
        raise ValueError(f"{path}: only continuous (.con) acquisitions "
                         f"supported, got type {acq_type}")
    sample_rate = f8(acq + 4)
    sample_count = i4(acq + 12)

    if not (0 < nchan < 10000 and 0 < sample_rate < 1e6
            and sample_count > 0):
        raise ValueError(
            f"{path}: implausible .con header (nchan={nchan}, "
            f"sfreq={sample_rate}, nsamp={sample_count}); the layout "
            "anchors in studies/kit.py may need adjusting for this file")
    return ConInfo(system_name=system_name, channel_count=nchan,
                   sample_rate=sample_rate, sample_count=sample_count,
                   ch_types=ch_types, ch_pos3=ch_pos3,
                   sens_gain=sens_gain, amp_gain=AMP_GAINS[amp_code],
                   data_offset=i4(SLOT_DATA))


def read_kit(path: tp.Union[str, Path]) -> RawData:
    """Read a KIT .con file into RawData (all channels, physical units,
    FIFF-style ch_kinds, normalized 2D positions)."""
    from .io import _positions_from_locs

    path = Path(path)
    info = read_con_info(path)
    buf = path.read_bytes()
    nchan, nsamp = info.channel_count, info.sample_count
    counts = np.frombuffer(buf, "<i2", count=nchan * nsamp,
                           offset=info.data_offset)
    data = counts.reshape(nsamp, nchan).T.astype(np.float32)
    volts_per_count = INPUT_RANGE_VOLTS / 2 ** ADC_BITS
    cal = volts_per_count / info.amp_gain * info.sens_gain
    data *= cal.astype(np.float32)[:, None]

    kinds = [_kind_of(int(t)) for t in info.ch_types]
    spatial = np.asarray([k == KIND_MEG for k in kinds])
    positions = _positions_from_locs(
        np.where(spatial[:, None], info.ch_pos3, 0.0).astype(np.float32))
    positions[~spatial] = INVALID_POSITION
    names = [f"MEG {k:03d}" if kinds[k] == KIND_MEG else
             f"MISC {k:03d}" for k in range(nchan)]
    return RawData(data=data, sample_rate=info.sample_rate,
                   ch_names=names, positions=positions, ch_kinds=kinds)


# -- writer (tests / interchange) ---------------------------------------------

def write_kit(path: tp.Union[str, Path], raw: RawData,
              sens_gain_meg: float = 1e-12,
              system_name: str = "brainmagick_tpu synthetic") -> None:
    """Write RawData as a .con file the reader round-trips. MEG values
    are quantized via sens_gain_meg Tesla/Volt."""
    kinds = raw.ch_kinds or [KIND_MEG] * raw.n_channels
    nchan, nsamp = raw.data.shape
    type_of = {KIND_MEG: CH_AXIAL_GRADIOMETER, KIND_EEG: CH_EEG,
               KIND_STIM: CH_TRIGGER, KIND_OTHER: CH_ETC}

    basic_off = 160
    basic = bytearray(532)
    struct.pack_into("<i", basic, 0, 2)       # version
    struct.pack_into("<i", basic, 4, 0)       # revision
    struct.pack_into("<i", basic, 8, 0)       # system id
    name_b = system_name.encode("latin1")[:127]
    basic[12:12 + len(name_b)] = name_b
    struct.pack_into("<i", basic, 268, nchan)

    chan_off = basic_off + len(basic)
    chans = bytearray(nchan * CHAN_RECORD_SIZE)
    for k, kind in enumerate(kinds):
        base = k * CHAN_RECORD_SIZE
        struct.pack_into("<i", chans, base, type_of.get(kind, CH_ETC))
        px, py = raw.positions[k]
        if kind == KIND_MEG and px != INVALID_POSITION:
            # normalized layout embedded on a unit hemisphere so the
            # azimuthal read-back projection recovers it monotonically
            struct.pack_into("<3d", chans, base + 4,
                             px - 0.5, py - 0.5, 0.5)

    sens_off = chan_off + len(chans)
    sens = bytearray(16 * nchan)
    gains = np.ones(nchan)
    for k, kind in enumerate(kinds):
        gains[k] = sens_gain_meg if kind == KIND_MEG else 1.0
        struct.pack_into("<2d", sens, 16 * k, 0.0, gains[k])

    amp_off = sens_off + len(sens)
    amp = struct.pack("<i", 0)                # gain code 0 -> 1.0

    acq_off = amp_off + len(amp)
    # acq layout: type i4, rate f8 at +4, sample_count i4 at +12
    acq = (struct.pack("<i", ACQ_CONTINUOUS)
           + struct.pack("<d", float(raw.sample_rate))
           + struct.pack("<ii", nsamp, nsamp))

    data_off = acq_off + len(acq)
    header = bytearray(basic_off)
    struct.pack_into("<i", header, SLOT_BASIC, basic_off)
    struct.pack_into("<ii", header, SLOT_CHANNELS, chan_off,
                     CHAN_RECORD_SIZE)
    struct.pack_into("<i", header, SLOT_SENSITIVITY, sens_off)
    struct.pack_into("<i", header, SLOT_AMPLIFIER, amp_off)
    struct.pack_into("<i", header, SLOT_ACQ, acq_off)
    struct.pack_into("<i", header, SLOT_DATA, data_off)

    volts_per_count = INPUT_RANGE_VOLTS / 2 ** ADC_BITS
    cal = volts_per_count * gains  # amp gain 1
    counts = np.rint(np.asarray(raw.data, np.float64) / cal[:, None])
    counts = np.clip(counts, -2 ** 15, 2 ** 15 - 1)
    payload = counts.T.astype("<i2").tobytes()

    Path(path).write_bytes(bytes(header) + bytes(basic) + bytes(chans)
                           + bytes(sens) + amp + acq + payload)
