"""The mock audio of the fake study.

Port of ``brainmagick_tpu/mockdata.py``: the same speech-like wav,
synthesized from the same seed on first use into the package's own
gitignored ``_mockdata/`` folder (its bytes equal the JAX package's).
"""

from __future__ import annotations

import os
import threading
import typing as tp
import wave
from pathlib import Path

import numpy as np

MOCK_WAV_SR = 16_000
MOCK_WAV_SECONDS = 8.0


def mock_wav_path(folder: tp.Optional[Path] = None) -> Path:
    """Path of the mock wav in `folder` (the package's ``_mockdata/`` when
    None), written if it is not there yet."""
    if folder is None:
        folder = Path(__file__).parent / "_mockdata"
    path = Path(folder) / "speechlike.wav"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(20230101)
    n = int(MOCK_WAV_SR * MOCK_WAV_SECONDS)
    t = np.arange(n) / MOCK_WAV_SR
    # slowly AM-modulated harmonics of a wandering pitch, plus smoothed noise
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.7 * t)
    sig = np.zeros(n)
    phase = np.cumsum(2 * np.pi * f0 / MOCK_WAV_SR)
    for h, amp in [(1, .5), (2, .3), (3, .2), (4, .1)]:
        sig += amp * np.sin(h * phase)
    envelope = .5 * (1 + np.sin(2 * np.pi * 3.1 * t))
    noise = rng.randn(n)
    noise = np.convolve(noise, np.ones(8) / 8, mode="same")
    sig = envelope * sig + 0.05 * noise
    sig = (sig / np.abs(sig).max() * 0.9 * 32767).astype(np.int16)
    tmp = path.with_name(
        f"{path.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    with wave.open(str(tmp), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(MOCK_WAV_SR)
        f.writeframes(sig.tobytes())
    tmp.rename(path)
    return path


def write_speech_wav(path: Path, seconds: float) -> Path:
    """A wav of `seconds` at MOCK_WAV_SR: the mock speech repeated, cut to
    length (a stimulus for the synthetic trees of the real studies)."""
    with wave.open(str(mock_wav_path()), "rb") as f:
        speech = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
    n = int(round(MOCK_WAV_SR * seconds))
    sig = np.resize(speech, n)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(MOCK_WAV_SR)
        f.writeframes(sig.tobytes())
    return path
