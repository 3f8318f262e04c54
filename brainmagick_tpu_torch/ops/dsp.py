"""Resampling and FIR filters as torch ops.

Port of ``brainmagick_tpu/ops/dsp.py`` (XLA there, not Pallas, so plain
torch here). The filter banks are built in numpy exactly as the JAX
package builds them (windowed-sinc designs with julius's conventions:
cutoffs as fractions of the sample rate, zero padding at the boundaries,
output length floor(T * new / old)), and applied with ``F.conv1d`` on
[..., T] tensors of any leading shape, on the tensor's device, inside
``precision.exact_fp32``: TF32 would keep 10 mantissa bits.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..precision import exact_fp32

#: the numerics version of the DSP, folded into every cache key derived
#: from it (the JAX package's value: same kernels, padding and lengths)
DSP_VERSION = 2


def _sinc(x: np.ndarray) -> np.ndarray:
    """sin(x)/x with the 0 -> 1 limit (not numpy's normalized sinc)."""
    return np.sinc(x / np.pi)


@lru_cache(maxsize=None)
def _resample_kernel(old_sr: int, new_sr: int, zeros: int, rolloff: float):
    """Polyphase windowed-sinc bank: (kernel [new, 1, width] fp32 numpy,
    width_left), with old_sr/new_sr reduced by their gcd; one row per
    output phase."""
    g = math.gcd(old_sr, new_sr)
    old_sr //= g
    new_sr //= g
    assert new_sr != old_sr
    sr = min(new_sr, old_sr) * rolloff
    width = int(math.ceil(zeros * old_sr / sr))
    idx = np.arange(-width, width + old_sr, dtype=np.float64)
    kernels = []
    for i in range(new_sr):
        t = (-i / new_sr + idx / old_sr) * sr
        t = np.clip(t, -zeros, zeros) * math.pi
        window = np.cos(t / zeros / 2) ** 2
        kernels.append(_sinc(t) * window * (sr / old_sr))
    kernel = np.stack(kernels).astype(np.float32)[:, None, :]
    return kernel, width


@exact_fp32()
def resample(x: torch.Tensor, old_sr: int, new_sr: int, *, zeros: int = 24,
             rolloff: float = 0.945, full: bool = False) -> torch.Tensor:
    """Resample fp32 [..., T] from old_sr to new_sr (integer rates):
    windowed-sinc polyphase with `zeros` zero crossings a side, a `rolloff`
    anti-aliasing margin, zero padding, and floor(T * new / old) samples
    (``full=True``: the ceil)."""
    old_sr, new_sr = int(old_sr), int(new_sr)
    if old_sr == new_sr:
        return x
    length = x.shape[-1]
    float_length = new_sr * length / old_sr
    output_length = int(math.ceil(float_length)) if full \
        else int(float_length)
    kernel_np, width = _resample_kernel(old_sr, new_sr, zeros, rolloff)
    kernel = torch.from_numpy(kernel_np).to(x.device)
    old_g = old_sr // math.gcd(old_sr, new_sr)
    shape = x.shape
    x2 = x.reshape(-1, 1, length)
    # julius.ResampleFrac's zero padding, F.pad((width, width + old))
    x2 = F.pad(x2, (width, width + old_g))
    ys = F.conv1d(x2, kernel, stride=old_g)            # [N, new, T // old]
    y = ys.transpose(1, 2).reshape(x2.shape[0], -1)[:, :output_length]
    return y.reshape(*shape[:-1], output_length)


@lru_cache(maxsize=None)
def _lowpass_kernel(cutoff: float, zeros: int):
    """Unit-DC-gain windowed-sinc FIR for a cutoff given as
    freq / sample_rate: (kernel [1, 1, 2h + 1] fp32 numpy, h)."""
    half_size = int(zeros / cutoff / 2)
    window = np.hanning(2 * half_size + 1)
    time = np.arange(-half_size, half_size + 1, dtype=np.float64)
    if cutoff == 0:
        filt = np.zeros_like(time)
    else:
        filt = 2 * cutoff * window * _sinc(2 * cutoff * math.pi * time)
        filt /= filt.sum()
    return filt.astype(np.float32)[None, None, :], half_size


@exact_fp32()
def lowpass_filter(x: torch.Tensor, cutoff: float, *,
                   zeros: int = 8) -> torch.Tensor:
    """Zero-phase FIR lowpass of fp32 [..., T]; `cutoff` is a fraction of
    the sample rate (julius.lowpass_filter's semantics)."""
    if cutoff >= 0.5:
        return x
    kernel_np, half_size = _lowpass_kernel(float(cutoff), int(zeros))
    kernel = torch.from_numpy(kernel_np).to(x.device)
    shape = x.shape
    x2 = F.pad(x.reshape(-1, 1, shape[-1]), (half_size, half_size))
    return F.conv1d(x2, kernel).reshape(shape)


def highpass_filter(x: torch.Tensor, cutoff: float, *,
                    zeros: int = 8) -> torch.Tensor:
    """Highpass by subtracting the lowpass."""
    return x - lowpass_filter(x, cutoff, zeros=zeros)
