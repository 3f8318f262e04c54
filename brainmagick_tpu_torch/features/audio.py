"""Audio features: the log-mel spectrogram and the YIN pitch of the sound
events.

Port of ``MelSpectrum`` and ``Pitch`` of
``brainmagick_tpu/features/audio.py``, with their helpers
(``_extract_wav_part``, ``_interp_nearest``, ``_mel_filterbank``,
``compute_yin``). ``melspectrogram`` frames the waveform in numpy and runs
the FFT (``torch.fft.rfft``) and the filterbank product in fp32 torch on
the host; ``compute_yin`` is float64 numpy. A feature is painted once per
recording into a track that the datasets keep as a host memmap, as the
JAX package does, so both resample a CPU tensor. The wav2vec 2.0
features (random=True) run the port's encoder (``models.wav2vec2``) on
the run's device and cache its outputs per sound event.
"""

from __future__ import annotations

import math
import threading
import typing as tp
import wave
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from .. import events
from ..cache import Cache, MemoryCache
from ..models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, seed_of
from ..ops.dsp import resample
from ..precision import exact_fp32
from ..utils import Frequency
from . import base


def _extract_wav_part(filepath: tp.Union[Path, str], onset: float,
                      offset: float) -> tp.Tuple[np.ndarray, Frequency]:
    """[channels, T] float32 of a PCM wav between `onset` and `offset`
    (seconds)."""
    with wave.open(str(filepath), "rb") as f:
        sr = Frequency(f.getframerate())
        n_channels = f.getnchannels()
        sampwidth = f.getsampwidth()
        start = sr.to_ind(onset)
        n_frames = sr.to_ind(offset - onset)
        f.setpos(min(start, f.getnframes()))
        n_frames = min(n_frames, f.getnframes() - start)
        raw = f.readframes(max(n_frames, 0))
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[sampwidth]
    data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    if sampwidth == 1:
        data = (data - 128.0) / 128.0
    else:
        data = data / float(2 ** (8 * sampwidth - 1))
    wav = data.reshape(-1, n_channels).T
    delta = abs(wav.shape[-1] / sr - offset + onset)
    assert delta <= 0.1, (delta, filepath, onset, offset)
    return wav, sr


def _interp_nearest(x: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resize along the last axis."""
    length = x.shape[-1]
    idx = (np.arange(size) * length // size).clip(0, length - 1)
    return x[..., idx]


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """HTK mel scale."""
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@lru_cache(maxsize=None)
def _mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """[n_freqs, n_mels] triangular filterbank on the HTK scale, without
    normalization."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(np.array(0.0)),
                          _hz_to_mel(np.array(sr / 2.0)), n_mels + 2)
    f_pts = _mel_to_hz(mel_pts)
    slopes = f_pts[None, :] - freqs[:, None]          # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / np.maximum(f_pts[1:-1] - f_pts[:-2], 1e-8)
    up = slopes[:, 2:] / np.maximum(f_pts[2:] - f_pts[1:-1], 1e-8)
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def melspectrogram(wav: np.ndarray, sr: int, n_fft: int, hop: int,
                   n_mels: int, normalized: bool = True) -> np.ndarray:
    """[T] waveform -> [n_mels, 1 + T // hop] power mel spectrogram:
    centred hann frames with reflect padding, the HTK mel scale, power 2.
    fp32 on the host."""
    pad = n_fft // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = torch.from_numpy(np.ascontiguousarray(x[idx], dtype=np.float32))
    window = torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32))
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    if normalized:
        power = power / torch.sum(window ** 2)
    fb = torch.from_numpy(_mel_filterbank(sr, n_fft, n_mels))
    return (power @ fb).T.numpy()


class MelSpectrum(base.Feature):
    """Log-mel spectrogram of the sound event, nearest-resampled to the
    feature rate; cached per (file, start, stop)."""

    event_kind = "sound"

    def __init__(self, sample_rate: Frequency, n_mels: int = 40,
                 n_fft: int = 512, in_sampling: int = 16_000,
                 normalized: bool = True, use_log_scale: bool = True,
                 log_scale_eps: float = 1e-5, norm_audio: bool = True) -> None:
        super().__init__(sample_rate)
        self.dimension = n_mels
        self.cache = Cache(self.__class__.__name__, dict(
            n_mels=n_mels, n_fft=n_fft, in_sampling=in_sampling,
            normalized=normalized, use_log_scale=use_log_scale,
            log_scale_eps=log_scale_eps, norm_audio=norm_audio))
        self.in_sampling = in_sampling
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop_length = n_fft // 4
        self.use_log_scale = use_log_scale
        self.log_scale_eps = log_scale_eps
        self.normalized = normalized
        self.norm_audio = norm_audio
        if use_log_scale:
            self.default_value = math.log10(log_scale_eps)

    def _compute(self, filepath: str, start: float, stop: float
                 ) -> np.ndarray:
        wav, sr = _extract_wav_part(filepath, start, stop)
        wav = wav.mean(axis=0)
        if self.norm_audio:
            wav = (wav - wav.mean()) / (1e-8 + wav.std())
        wav = resample(torch.from_numpy(np.ascontiguousarray(wav)), int(sr),
                       self.in_sampling).numpy()
        mel = melspectrogram(wav, self.in_sampling, self.n_fft,
                             self.hop_length, self.n_mels, self.normalized)
        if self.use_log_scale:
            mel = np.log10(mel + self.log_scale_eps)
        return mel.astype(np.float32)

    def get(self, event: events.Sound) -> np.ndarray:
        mel = self.cache.get(self._compute, filepath=str(event.filepath),
                             start=event.offset,
                             stop=event.offset + event.duration)
        n = self.sample_rate.to_ind(event.stop - event.start)
        return _interp_nearest(np.asarray(mel), n)


def compute_yin(sig: np.ndarray, sr: int, w_len: int = 512,
                w_step: int = 256, f0_min: float = 100.,
                f0_max: float = 500., harmo_thresh: float = 0.1):
    """YIN fundamental-frequency estimation (de Cheveigne and Kawahara
    2002), vectorized in float64 numpy: the difference function of every
    frame at once through d(tau) = r(0) + r_tau(0) - 2 corr(tau) (the
    correlation by FFT), the cumulative-mean normalization, then per frame
    the first lag below `harmo_thresh` walked down to its local minimum
    (pitch sr / lag), else the global minimum (pitch 0).

    Returns (pitches, harmonic_rates, argmins, times) per frame."""
    tau_min = int(sr / f0_max)
    tau_max = int(sr / f0_min)
    starts = np.arange(0, len(sig) - w_len - tau_max, w_step, dtype=int)
    if len(starts) == 0:
        return [0.0], [0.0], [0.0], [0.0]
    # frames [n, w_len + tau_max]
    idx = starts[:, None] + np.arange(w_len + tau_max)[None, :]
    frames = sig[idx].astype(np.float64)
    x = frames[:, :w_len]
    # d(tau) = sum_j (x_j - x_{j + tau})^2 for tau < tau_max
    n_fft = 1
    while n_fft < w_len + tau_max:
        n_fft *= 2
    fx = np.fft.rfft(frames, n_fft)
    fy = np.fft.rfft(x[:, ::-1], n_fft)
    corr = np.fft.irfft(fx * fy, n_fft)[:, w_len - 1: w_len + tau_max]
    sq = frames ** 2
    cum = np.cumsum(sq, axis=1)
    e0 = cum[:, w_len - 1]                       # the energy of x
    # the energy of the window shifted by tau
    etau = np.concatenate([
        e0[:, None], cum[:, w_len:] - cum[:, :tau_max]], axis=1)
    d = e0[:, None] + etau - 2 * corr            # [n, tau_max + 1]
    d = np.maximum(d[:, :tau_max], 0.0)
    # the cumulative mean normalized difference
    tau = np.arange(1, tau_max)
    cmnd = np.empty_like(d)
    cmnd[:, 0] = 1.0
    csum = np.cumsum(d[:, 1:], axis=1)
    cmnd[:, 1:] = d[:, 1:] * tau / np.maximum(csum, 1e-12)

    pitches = np.zeros(len(starts))
    harmonic_rates = np.zeros(len(starts))
    argmins = np.zeros(len(starts))
    times = starts / float(sr)
    for i in range(len(starts)):
        row = cmnd[i]
        below = np.flatnonzero(row[tau_min:tau_max] < harmo_thresh)
        if len(below):
            t = tau_min + below[0]
            while t + 1 < tau_max and row[t + 1] < row[t]:
                t += 1
            pitches[i] = sr / t
            harmonic_rates[i] = row[t]
        else:
            t = tau_min + int(np.argmin(row[tau_min:tau_max]))
            harmonic_rates[i] = row[t]
        if np.argmin(row) > tau_min:
            argmins[i] = sr / np.argmin(row)
    return pitches, harmonic_rates, argmins, times


class Pitch(base.Feature):
    """The YIN pitch track of the sound event: the mono mix resampled to
    16 kHz, YIN over frames of `frame_length_in_samples` every
    `frame_space_in_samples`, nearest-resampled to the feature rate;
    cached per (file, start, stop)."""

    event_kind = "sound"

    def __init__(self, sample_rate: Frequency, min_f0: float = 100.0,
                 max_f0: float = 350.0, harmonic_thresh: float = 0.1,
                 frame_length_in_samples: int = 256,
                 frame_space_in_samples: int = 64) -> None:
        super().__init__(sample_rate)
        self.cache = Cache(self.__class__.__name__, dict(
            min_f0=min_f0, max_f0=max_f0, harmonic_thresh=harmonic_thresh,
            frame_length_in_samples=frame_length_in_samples,
            frame_space_in_samples=frame_space_in_samples))
        self.frame_length_in_samples = frame_length_in_samples
        self.frame_space_in_samples = frame_space_in_samples
        self.harmonic_thresh = harmonic_thresh
        self.min_f0 = min_f0
        self.max_f0 = max_f0
        self.in_sampling = 16_000

    def _compute(self, filepath: str, start: float, stop: float
                 ) -> np.ndarray:
        wav, sr = _extract_wav_part(filepath, start, stop)
        wav = wav.mean(axis=0)
        wav = resample(torch.from_numpy(np.ascontiguousarray(wav)), int(sr),
                       self.in_sampling).numpy()
        pitches, _, _, _ = compute_yin(
            sig=wav, sr=self.in_sampling, w_len=self.frame_length_in_samples,
            w_step=self.frame_space_in_samples,
            harmo_thresh=self.harmonic_thresh,
            f0_min=self.min_f0, f0_max=self.max_f0)
        return np.asarray(pitches, dtype=np.float32)

    def get(self, event: events.Sound) -> np.ndarray:
        pitches = self.cache.get(self._compute, filepath=str(event.filepath),
                                 start=event.offset,
                                 stop=event.offset + event.duration)
        n = self.sample_rate.to_ind(event.stop - event.start)
        return _interp_nearest(np.asarray(pitches), n)[None]


#: one wav2vec 2.0 forward at a time in the process: ``exact_fp32`` sets
#: process-wide flags, and the scaler fit renders tracks in a thread per
#: recording, so another thread's exit would turn TF32 back on under a
#: convolution of this one
_FORWARD_LOCK = threading.Lock()


class _BaseWav2Vec(base.Feature):
    """Shared wav2vec 2.0 machinery: the sound event's waveform at 16 kHz
    through the port's encoder (``models.wav2vec2``), its outputs cached
    as memmaps per (file, start, stop, output, layers).

    Only ``random=True`` is ported: the xlsr-53 architecture from literal
    values, its weights drawn as HF draws them, seeded from the model name
    as the JAX package seeds them, so both packages compute the same
    network (bit for bit at the weights). ``random=False`` needs the
    pretrained checkpoint, which the port does not read: it raises
    RuntimeError, as the JAX package does without the checkpoint.

    The encoder runs in fp32 (``precision.exact_fp32``) on ``self.device``,
    which the datasets set to the run's ``device`` (the card by default;
    ``FeaturesBuilder(device=...)``). The ``device`` parameter is the JAX
    package's key, which places HF's model there; the port keeps it for
    the config's sake (the same overrides give the same XP signature in
    both packages) and it places nothing."""

    event_kind = "sound"
    model_name = "facebook/wav2vec2-large-xlsr-53"
    model_sr = 16_000

    def __init__(self, sample_rate: Frequency, normalized: bool = True,
                 random: bool = False, device: str = "cpu") -> None:
        super().__init__(sample_rate)
        # "seeded" marks the seeded random network, as in the JAX package
        args: tp.Any = ((self.model_name, random, "seeded")
                        if random else self.model_name)
        self.cache = Cache("Wav2VecEmbedding", args, mode="memmap")
        self.normalized = normalized
        self.random = random
        self.device = torch.device("cpu")
        # one model a process for each (name, random)
        self._model_cache = MemoryCache(
            "Wav2VecEmbedding", ("model", self.model_name, random))

    def place(self, device: tp.Union[str, torch.device]) -> None:
        self.device = torch.device(device)

    def _load_model(self) -> Wav2Vec2Model:
        if not self.random:
            raise RuntimeError(
                f"wav2vec2 checkpoint '{self.model_name}' is not read by "
                "brainmagick_tpu_torch (no checkpoint ships with the "
                "repository and none can be downloaded). Use random=True "
                "or MelSpectrum features.")
        return Wav2Vec2Model(Wav2Vec2Config.xlsr53(), torch.Generator(
            ).manual_seed(seed_of(self.model_name))).eval()

    @property
    def model(self) -> Wav2Vec2Model:
        return self._model_cache.get(self._load_model)

    def _preprocess_wav(self, filepath: str, start: float, stop: float
                        ) -> torch.Tensor:
        """[1, T] fp32 mono waveform at 16 kHz, zero-mean unit-variance
        when ``normalized`` (as HF's Wav2Vec2FeatureExtractor)."""
        wav, sr = _extract_wav_part(filepath, start, stop)
        wav = wav.mean(axis=0)
        wav = resample(torch.from_numpy(np.ascontiguousarray(wav)), int(sr),
                       self.model_sr).numpy()
        if self.normalized:
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
        return torch.from_numpy(wav.astype(np.float32))[None]

    def _compute_hidden_states(self, name: str, filepath: str, start: float,
                               stop: float,
                               layers: tp.Optional[tp.List[int]] = None
                               ) -> np.ndarray:
        wav = self._preprocess_wav(filepath, start, stop)
        with _FORWARD_LOCK, torch.no_grad(), exact_fp32():
            model = self.model.to(self.device)
            wav = wav.to(self.device)
            if name == "hidden_states":
                out = torch.stack(model(wav, layers)[2])
                if layers is not None:
                    out = out.mean(0)
            elif name == "extract_features":
                out = model.frontend(wav)[1]
            else:
                raise KeyError(name)
            return out.cpu().numpy()

    def _get_cached(self, event: events.Sound, overlap, name: str,
                    layers: tp.Optional[tp.List[int]] = None) -> np.ndarray:
        outputs = self.cache.get(
            self._compute_hidden_states, start=event.offset,
            stop=event.offset + event.duration,
            filepath=str(event.filepath), name=name, layers=layers)
        embd_sr = outputs.shape[-2] / event.duration
        if event.duration >= 0.5:
            assert 42 < embd_sr < 52, \
                f"Unexpected embedding sampling rate {embd_sr}"
        sr = Frequency(embd_sr)
        start, stop = [sr.to_ind(x - event.start)
                       for x in (overlap.start, overlap.stop)]
        start = min(start, outputs.shape[-2] - 1)
        stop = max(start + 1, stop)
        return np.array(outputs[..., start:stop, :], copy=True)

    def get(self, event: tp.Any) -> tp.Any:
        raise RuntimeError(
            f"Only get_on_overlap is available for {self.name}")


class Wav2VecTransformer(_BaseWav2Vec):
    """Mean of transformer hidden-state layers (default 14-18), dim
    1024."""
    dimension = 1024

    def __init__(self, sample_rate: Frequency, normalized: bool = True,
                 layers: tp.Tuple[int, ...] = (14, 15, 16, 17, 18),
                 random: bool = False, device: str = "cpu") -> None:
        super().__init__(sample_rate=sample_rate, normalized=normalized,
                         device=device, random=random)
        self.layers = tuple(layers)

    def get_on_overlap(self, event: events.Sound, overlap) -> np.ndarray:
        out = self._get_cached(event, overlap, "hidden_states",
                               list(self.layers))
        out = out[0].T  # [1, T, D] -> [D, T]
        return _interp_nearest(out, overlap.duration_ind)


class Wav2VecConvolution(_BaseWav2Vec):
    """Output of the conv feature encoder (after the projection's
    LayerNorm, HF's extract_features), dim 512."""
    dimension = 512

    def get_on_overlap(self, event: events.Sound, overlap) -> np.ndarray:
        out = self._get_cached(event, overlap, "extract_features")
        out = out[0].T
        return _interp_nearest(out, overlap.duration_ind)


class Wav2VecChunk(_BaseWav2Vec):
    """Raw 16 kHz waveform chunk for end-to-end wav2vec feature models.
    Forces its own 16 kHz sample rate; runs no model."""
    dimension = 1
    normalizable = False

    def __init__(self, sample_rate: Frequency, normalized: bool = True,
                 random: bool = False, device: str = "cpu") -> None:
        super().__init__(sample_rate=Frequency(16_000),
                         normalized=normalized, device=device, random=random)

    def get(self, event: events.Sound) -> np.ndarray:
        wav = self._preprocess_wav(str(event.filepath), event.offset,
                                   event.offset + event.duration)
        return wav.numpy()
