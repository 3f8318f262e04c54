"""Fused per-recording normalization + clamp + peak over MEG batches.

Port of ``brainmagick_tpu/ops/pallas_norm.py``: for each sample b,

    out[b]  = clip((meg[b] - center[b]) / scale[b], -limit, limit)
    peak[b] = max_{c,t} |(meg[b] - center[b]) / scale[b]|   (pre-clamp)

with ``center``/``scale`` already gathered per sample. On a CUDA tensor
it launches a hand-written Triton kernel; on a CPU tensor it runs the
plain version, ``_reference_impl``.

Kernel note. The Pallas kernel (``pallas_norm.py:_kernel``) took one
whole [1, C, T] row per sequential grid step. On the H100 the op is bound
by device-memory bandwidth: one fp32 read and one write of the batch,
2 x 101 MB at B=256, C=273, T=361, against 3.35 TB/s (about 60 us). So
the Triton kernel cuts each row into blocks of 4096 elements and launches
a 2D grid (row, block): many independent programs keep enough loads in
flight at any B, including B=1. Each program reduces its block's |normed|
with ``tl.max`` and folds it into ``peak[b]`` with ``tl.atomic_max``
(exact on non-negative floats, any order). The division is IEEE-rounded
(``div_rn``), so out and peak equal the plain version bit for bit.
Triton's launcher raises on a failed launch.
"""

from __future__ import annotations

import functools

import torch

_BLOCK = 4096
_NUM_WARPS = 8


def _reference_impl(meg: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, limit: float, clip: bool):
    normed = (meg - center[:, :, None]) / scale[:, :, None]
    peak = normed.abs().amax(dim=(1, 2))
    if clip:
        normed = normed.clamp(-limit, limit)
    return normed, peak


@functools.cache
def _kernel():
    """Compile-on-first-use Triton kernel (triton is imported here, not
    at module import, so CPU-only hosts can import this module)."""
    import triton
    import triton.language as tl

    @triton.jit
    def normalize_kernel(meg_ptr, center_ptr, scale_ptr, out_ptr, peak_ptr,
                         n_channels, n_times, limit,
                         CLIP: tl.constexpr, BLOCK: tl.constexpr):
        b = tl.program_id(0)
        row_len = n_channels * n_times
        offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        inside = offs < row_len
        row = b.to(tl.int64) * row_len
        x = tl.load(meg_ptr + row + offs, mask=inside, other=0.0)
        chan = b * n_channels + offs // n_times
        center = tl.load(center_ptr + chan, mask=inside, other=0.0)
        scale = tl.load(scale_ptr + chan, mask=inside, other=1.0)
        normed = tl.math.div_rn(x - center, scale)
        block_peak = tl.max(tl.where(inside, tl.abs(normed), 0.0), axis=0)
        tl.atomic_max(peak_ptr + b, block_peak)
        if CLIP:
            normed = tl.minimum(tl.maximum(normed, -limit), limit)
        tl.store(out_ptr + row + offs, normed, mask=inside)

    return normalize_kernel


def normalize_clamp_peak(meg: torch.Tensor, center: torch.Tensor,
                         scale: torch.Tensor, limit: float,
                         clip: bool = True):
    """meg [B, C, T] fp32, center/scale [B, C] fp32 (gathered per sample)
    -> (normalized, clamped when `clip`, [B, C, T]; pre-clamp peak [B])."""
    if meg.dim() != 3 or center.shape != meg.shape[:2] \
            or scale.shape != meg.shape[:2]:
        raise ValueError(
            f"normalize_clamp_peak needs meg [B, C, T] and center/scale "
            f"[B, C], got {tuple(meg.shape)}, {tuple(center.shape)}, "
            f"{tuple(scale.shape)}")
    for t in (meg, center, scale):
        if t.dtype != torch.float32:
            raise TypeError(f"normalize_clamp_peak takes fp32, got {t.dtype}")
        if t.device != meg.device:
            raise ValueError(f"tensors on {meg.device} and {t.device}")
    if meg.device.type == "cpu":
        return _reference_impl(meg, center, scale, limit, clip)
    if meg.device.type != "cuda":
        raise ValueError(f"normalize_clamp_peak runs on cpu or cuda, not "
                         f"{meg.device}")
    if not all(t.is_contiguous() for t in (meg, center, scale)):
        raise ValueError("normalize_clamp_peak needs contiguous tensors")
    batch, channels, times = meg.shape
    out = torch.empty_like(meg)
    # |x| >= 0, so 0 is the identity of the atomic max
    peak = torch.zeros(batch, dtype=torch.float32, device=meg.device)
    row_len = channels * times
    if batch == 0 or row_len == 0:
        return out, peak
    grid = (batch, -(-row_len // _BLOCK))
    with torch.cuda.device(meg.device):
        _kernel()[grid](meg, center, scale, out, peak, channels, times,
                        float(limit), CLIP=bool(clip), BLOCK=_BLOCK,
                        num_warps=_NUM_WARPS)
    normalize_clamp_peak.launches += 1
    return out, peak


#: kernel launches since the last reset (the CPU path does not count)
normalize_clamp_peak.launches = 0
