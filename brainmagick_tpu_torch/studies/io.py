"""FIF raw files: reader, writer and trigger extraction.

Port of ``brainmagick_tpu/studies/io.py``. FIF is a flat sequence of
tags, each a 16-byte big-endian header (kind, type, size, next) and
`size` bytes of data. The measurement info (nchan 200, sfreq 201,
ch_info 203) precedes the raw-data block, whose DATA_BUFFER (300) tags
hold the samples [n_samp, n_chan], scaled per channel by cal * range.
A channel's 2D position is an azimuthal projection of its ch_info coil
location, normalized to [0, 1]^2.
"""

from __future__ import annotations

import struct
import typing as tp
from pathlib import Path

import numpy as np

from .api import INVALID_POSITION, RawData

# tag kinds
FIFF_NCHAN = 200
FIFF_SFREQ = 201
FIFF_CH_INFO = 203
FIFF_FIRST_SAMPLE = 208
FIFF_DATA_BUFFER = 300
FIFF_DATA_SKIP = 301
FIFF_BLOCK_START = 104
FIFF_BLOCK_END = 105

# block kinds
FIFFB_RAW_DATA = 102
FIFFB_CONTINUOUS_DATA = 112
FIFFB_IAS_RAW_DATA = 119
_RAW_BLOCKS = {FIFFB_RAW_DATA, FIFFB_CONTINUOUS_DATA, FIFFB_IAS_RAW_DATA}

# tag data types
FIFFT_INT16 = 2
FIFFT_INT32 = 3
FIFFT_FLOAT = 4
FIFFT_DOUBLE = 5
FIFFT_CH_INFO = 30

_DTYPES = {FIFFT_INT16: ">i2", FIFFT_INT32: ">i4", FIFFT_FLOAT: ">f4",
           FIFFT_DOUBLE: ">f8"}

_CH_INFO = struct.Struct(">iiiffi12fii16s")  # 96 bytes

# channel kinds
FIFFV_MEG_CH = 1
FIFFV_EEG_CH = 2
FIFFV_STIM_CH = 3


class _ChannelInfo(tp.NamedTuple):
    name: str
    kind: int
    cal: float
    range: float
    loc: np.ndarray  # [12] floats; loc[0:3] = position


def _iter_tags(buf: memoryview
               ) -> tp.Iterator[tp.Tuple[int, int, memoryview]]:
    pos = 0
    n = len(buf)
    while pos + 16 <= n:
        kind, dtype, size, next_ptr = struct.unpack_from(">iiii", buf, pos)
        pos += 16
        if size < 0 or pos + size > n:
            break
        yield kind, dtype, buf[pos:pos + size]
        if next_ptr > 0:
            pos = next_ptr
        elif next_ptr == -1:
            break
        else:
            pos += size


def _positions_from_locs(locs: np.ndarray) -> np.ndarray:
    """[C, >=3] 3D coil positions -> [C, 2] normalized layout, by an
    azimuthal-equidistant projection about their centre (INVALID_POSITION
    for a channel at the origin)."""
    pos3 = locs[:, :3]
    valid = np.linalg.norm(pos3, axis=1) > 1e-9
    out = np.full((len(locs), 2), INVALID_POSITION, dtype=np.float32)
    if valid.sum() < 3:
        return out
    p = pos3[valid]
    center = p.mean(axis=0)
    q = p - center
    r = np.linalg.norm(q, axis=1)
    r = np.maximum(r, 1e-9)
    theta = np.arccos(np.clip(q[:, 2] / r, -1, 1))   # polar from +z
    phi = np.arctan2(q[:, 1], q[:, 0])
    x = theta * np.cos(phi)
    y = theta * np.sin(phi)
    x = (x - x.min()) / max(x.max() - x.min(), 1e-9)
    y = (y - y.min()) / max(y.max() - y.min(), 1e-9)
    out[valid, 0] = x
    out[valid, 1] = y
    return out


def read_fif(path: tp.Union[str, Path]) -> RawData:
    """A raw FIF file as RawData, in physical units."""
    buf = memoryview(Path(path).read_bytes())
    nchan: tp.Optional[int] = None
    sfreq: tp.Optional[float] = None
    channels: tp.List[_ChannelInfo] = []
    buffers: tp.List[np.ndarray] = []
    in_raw_block = 0
    for kind, dtype, payload in _iter_tags(buf):
        if kind == FIFF_BLOCK_START and dtype == FIFFT_INT32:
            if struct.unpack(">i", payload)[0] in _RAW_BLOCKS:
                in_raw_block += 1
        elif kind == FIFF_BLOCK_END and dtype == FIFFT_INT32:
            if struct.unpack(">i", payload)[0] in _RAW_BLOCKS \
                    and in_raw_block:
                in_raw_block -= 1
        elif kind == FIFF_NCHAN:
            nchan = int(np.frombuffer(payload, ">i4")[0])
        elif kind == FIFF_SFREQ:
            sfreq = float(np.frombuffer(payload, ">f4")[0])
        elif kind == FIFF_CH_INFO and dtype == FIFFT_CH_INFO:
            (_, _, ch_kind, rng, cal, _, *rest
             ) = _CH_INFO.unpack(bytes(payload))
            loc = np.array(rest[:12], dtype=np.float32)
            name = rest[14].split(b"\x00")[0].decode("latin1")
            channels.append(_ChannelInfo(name=name, kind=ch_kind, cal=cal,
                                         range=rng, loc=loc))
        elif kind == FIFF_DATA_BUFFER and in_raw_block:
            if dtype not in _DTYPES:
                raise ValueError(f"Unsupported FIF buffer dtype {dtype}")
            buffers.append(np.frombuffer(payload, _DTYPES[dtype]))
    if nchan is None or sfreq is None or not channels:
        raise ValueError(f"{path}: missing measurement info "
                         f"(nchan={nchan}, sfreq={sfreq}, "
                         f"{len(channels)} channels)")
    assert len(channels) == nchan, (len(channels), nchan)
    if not buffers:
        raise ValueError(f"{path}: no raw data buffers found")
    samples = np.concatenate(buffers)
    assert samples.size % nchan == 0, "truncated data buffer"
    data = samples.reshape(-1, nchan).T.astype(np.float32)
    scale = np.array([c.cal * c.range for c in channels],
                     dtype=np.float32)[:, None]
    data = data * scale
    locs = np.stack([c.loc for c in channels])
    return RawData(data=data, sample_rate=sfreq,
                   ch_names=[c.name for c in channels],
                   positions=_positions_from_locs(locs),
                   ch_kinds=[c.kind for c in channels])


def write_fif(path: tp.Union[str, Path], raw: RawData,
              buffer_samples: int = 1000) -> None:
    """`raw` as a raw FIF file of fp32 buffers with unit calibration."""
    chunks: tp.List[bytes] = []

    def tag(kind: int, dtype: int, payload: bytes) -> None:
        chunks.append(struct.pack(">iiii", kind, dtype, len(payload), 0))
        chunks.append(payload)

    tag(FIFF_NCHAN, FIFFT_INT32, struct.pack(">i", raw.n_channels))
    tag(FIFF_SFREQ, FIFFT_FLOAT, struct.pack(">f", float(raw.sample_rate)))
    for k, name in enumerate(raw.ch_names):
        loc = np.zeros(12, dtype=np.float32)
        px, py = raw.positions[k]
        if px != INVALID_POSITION:
            # the layout on a unit hemisphere, which the projection of
            # the reader recovers monotonically
            loc[0], loc[1], loc[2] = px - 0.5, py - 0.5, 0.5
        kind = raw.ch_kinds[k] if raw.ch_kinds is not None else 1
        payload = _CH_INFO.pack(
            k, k, kind, 1.0, 1.0, 0, *loc.tolist(), 112, 0,
            name.encode("latin1")[:16].ljust(16, b"\x00"))
        tag(FIFF_CH_INFO, FIFFT_CH_INFO, payload)
    tag(FIFF_BLOCK_START, FIFFT_INT32, struct.pack(">i", FIFFB_RAW_DATA))
    data = np.asarray(raw.data, dtype=np.float32)
    for lo in range(0, data.shape[1], buffer_samples):
        block = data[:, lo:lo + buffer_samples].T.astype(">f4")
        tag(FIFF_DATA_BUFFER, FIFFT_FLOAT, block.tobytes())
    tag(FIFF_BLOCK_END, FIFFT_INT32, struct.pack(">i", FIFFB_RAW_DATA))
    Path(path).write_bytes(b"".join(chunks))


def find_events(stim: np.ndarray, shortest_event: int = 1) -> np.ndarray:
    """A stim channel's [T] values -> [N, 3] rows (sample, previous value,
    new value) at each change to a non-zero value that holds for
    `shortest_event` samples."""
    vals = np.rint(stim).astype(np.int64)
    change = np.flatnonzero(np.diff(vals) != 0) + 1
    events = []
    for idx in change:
        if vals[idx] != 0:
            stop = min(idx + shortest_event, len(vals))
            if np.all(vals[idx:stop] == vals[idx]):
                events.append((idx, vals[idx - 1], vals[idx]))
    return np.asarray(events, dtype=np.int64).reshape(-1, 3)
