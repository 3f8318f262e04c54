"""Fused per-recording normalization + clamp + peak over MEG batches.

Port of ``brainmagick_tpu/ops/pallas_norm.py``: for each sample b,

    out[b]  = clip((meg[b] - center[r(b)]) / scale[r(b)], -limit, limit)
    peak[b] = max_{c,t} |(meg[b] - center[r(b)]) / scale[r(b)]|  (pre-clamp)

With ``rec=None``, ``center``/``scale`` are already gathered per sample
([B, C], the JAX function's contract, r(b) = b). With ``rec`` [B] int64
they are the recordings' [R, C] tables and r(b) = rec[b], the gather that
``Solver._forward`` made before the call, taken with JAX's rule for an
index out of range (``gather_index``). ``meg`` is fp32 or bf16 (the bf16
wire format, upcast exactly); ``out`` and ``peak`` are fp32. A NaN
propagates as in the JAX function: the row's peak is NaN and the element
stays NaN through the clamp; an inf gives an inf peak and is clamped to
±limit.

On a CUDA tensor it launches the hand-written kernel of
``csrc/normalize.cu`` (design note there); on a CPU tensor it runs the
plain version, ``_reference_impl``. The wrapper calls the custom op
``torch.ops.brainmagick.normalize_clamp_peak``, whose fake implementation
gives ``torch.export`` the output shapes, so an exported forward keeps the
op and, called on the card, launches the kernel.
"""

from __future__ import annotations

import typing as tp

import torch

from . import _build

#: the types meg may have (fp32, and the bf16 wire format)
INPUT_TYPES = (torch.float32, torch.bfloat16)
#: (b, c) rows a block takes at most (its shared center and scale)
MAX_ROWS = 64
#: elements a block aims at, at least and at most
_MIN_BLOCK, _MAX_BLOCK = 1024, 8192
#: blocks of 256 threads the H100 holds at once: 132 SMs x 8
_RESIDENT_BLOCKS = 132 * 8


def gather_index(rec: torch.Tensor, rows: int) -> torch.Tensor:
    """JAX's rule for ``table[rec]`` (``Solver._forward``'s gather): a
    negative index counts from the end, then every index is clamped into
    [0, rows), so no index reads outside the table."""
    return torch.where(rec < 0, rec + rows, rec).clamp(0, rows - 1)


def _reference_impl(meg: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, limit: float, clip: bool,
                    rec: tp.Optional[torch.Tensor] = None):
    if rec is not None:
        index = gather_index(rec, center.shape[0])
        center, scale = center[index], scale[index]
    normed = (meg.float() - center[:, :, None]) / scale[:, :, None]
    peak = normed.abs().amax(dim=(1, 2))
    if clip:
        normed = normed.clamp(-limit, limit)
    return normed, peak


def divider(d: int) -> tp.Tuple[int, int]:
    """(magic, shift) with n // d == (n * magic) >> shift for every 0 <= n
    < 2^31 (Granlund and Montgomery: magic = ceil(2^(31 + l) / d), l =
    ceil(log2 d), so magic d - 2^(31 + l) < d <= 2^l); magic < 2^32."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divider needs 1 <= d < 2^31, got {d}")
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


def plan_rows(batch: int, channels: int, times: int) -> int:
    """(b, c) rows per block: blocks of _MIN_BLOCK to _MAX_BLOCK elements,
    as many as the card holds at once when the batch is small, the rows
    of a sample spread evenly over its blocks; at most MAX_ROWS."""
    target = min(_MAX_BLOCK, max(_MIN_BLOCK, batch * channels * times
                                 // _RESIDENT_BLOCKS))
    blocks = -(-channels * times // target)
    return max(1, min(MAX_ROWS, -(-channels // blocks)))


def _kernel(meg: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
            rec: tp.Optional[torch.Tensor], out: torch.Tensor,
            peak: torch.Tensor, limit: float, clip: bool) -> None:
    """The kernel alone (with its zeroing of peak) on checked operands,
    into out [B, C, T] and peak [B] fp32."""
    batch, channels, times = meg.shape
    magic, shift = divider(times)
    with torch.cuda.device(meg.device):
        status = _build.library().bm_normalize_clamp_peak(
            meg.data_ptr(), int(meg.dtype == torch.bfloat16),
            center.data_ptr(), scale.data_ptr(),
            None if rec is None else rec.data_ptr(), out.data_ptr(),
            peak.data_ptr(), batch, channels, times, center.shape[0],
            float(limit), int(clip), plan_rows(batch, channels, times),
            magic, shift, torch.cuda.current_stream(meg.device).cuda_stream)
    _build.check_status("normalize_clamp_peak", status)


def _normalize(meg: torch.Tensor, center: torch.Tensor,
               scale: torch.Tensor, rec: tp.Optional[torch.Tensor],
               limit: float, clip: bool
               ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The custom op's implementation: the checks, then the kernel for a
    CUDA tensor (counted in ``normalize_clamp_peak.launches``) or the plain
    version for a CPU tensor."""
    tables = center.shape[:1] if rec is None else (rec.shape[0],)
    if meg.dim() != 3 or center.dim() != 2 or scale.shape != center.shape \
            or center.shape[1] != meg.shape[1] or tables != meg.shape[:1]:
        raise ValueError(
            f"normalize_clamp_peak needs meg [B, C, T] and center/scale "
            f"[B, C] (or [R, C] with rec [B]), got {tuple(meg.shape)}, "
            f"{tuple(center.shape)}, {tuple(scale.shape)}, rec "
            f"{None if rec is None else tuple(rec.shape)}")
    if meg.dtype not in INPUT_TYPES or center.dtype != torch.float32 \
            or scale.dtype != torch.float32:
        raise TypeError(f"normalize_clamp_peak takes fp32 or bf16 meg and "
                        f"fp32 center/scale, got {meg.dtype}, {center.dtype}"
                        f", {scale.dtype}")
    operands = (meg, center, scale)
    if rec is not None:
        if rec.dtype != torch.int64 or rec.dim() != 1:
            raise TypeError(f"rec must be int64 [B], got {rec.dtype} "
                            f"{tuple(rec.shape)}")
        if center.shape[0] == 0 and rec.shape[0] > 0:
            raise ValueError("rec indexes empty tables")
        operands += (rec,)
    for t in operands:
        if t.device != meg.device:
            raise ValueError(f"tensors on {meg.device} and {t.device}")
    if meg.device.type == "cpu":
        return _reference_impl(meg, center, scale, limit, clip, rec)
    _check_device(meg)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("normalize_clamp_peak needs contiguous tensors")
    batch, channels, times = meg.shape
    if channels * times >= 2 ** 31:
        raise ValueError(f"normalize_clamp_peak takes C T < 2^31 elements "
                         f"a sample, got {channels} x {times}")
    out = torch.empty(meg.shape, dtype=torch.float32, device=meg.device)
    peak = torch.empty(batch, dtype=torch.float32, device=meg.device)
    if batch == 0 or channels * times == 0:
        return out, peak.zero_()
    _kernel(meg, center, scale, rec, out, peak, limit, clip)
    normalize_clamp_peak.launches += 1
    return out, peak


def _check_device(meg: torch.Tensor) -> None:
    if meg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"normalize_clamp_peak runs on cpu or cuda, not "
                         f"{meg.device}")


#: the registered op: ``torch.export`` records it by this name, which
#: saved artifacts keep
OP = torch.library.custom_op(
    "brainmagick::normalize_clamp_peak", _normalize, mutates_args=(),
    schema="(Tensor meg, Tensor center, Tensor scale, Tensor? rec, "
           "float limit, bool clip) -> (Tensor, Tensor)")


@OP.register_fake
def _(meg, center, scale, rec, limit, clip):
    return (meg.new_empty(meg.shape, dtype=torch.float32),
            meg.new_empty(meg.shape[:1], dtype=torch.float32))


def normalize_clamp_peak(meg: torch.Tensor, center: torch.Tensor,
                         scale: torch.Tensor, limit: float,
                         clip: bool = True,
                         rec: tp.Optional[torch.Tensor] = None):
    """meg [B, C, T] fp32 or bf16; center/scale fp32, [B, C] with `rec`
    None, else [R, C] tables gathered through rec [B] int64 -> (out fp32
    [B, C, T], clamped when `clip`; pre-clamp peak [B] fp32), through the
    registered op (``OP``), which ``torch.export`` keeps in its graph: its
    checks run in the op, where no symbolic size meets them."""
    _check_device(meg)
    return OP(meg, center, scale, rec, float(limit), bool(clip))


#: kernel launches since the last reset (the CPU path does not count)
normalize_clamp_peak.launches = 0
