"""Fused dilated conv + BatchNorm statistics.

Port of ``brainmagick_tpu/ops/pallas_conv_bn.py``: ``conv_stats(x, w,
dilation)`` computes the dilated SAME conv1d (stride 1, odd k, no bias)
and the per-channel totals of its fp32 accumulator,

    y[b, o, t] = sum_{c, j} w[o, c, j] x[b, c, t + j d - (k // 2) d]
    s[o] = sum_{b, t} y[b, o, t],   ss[o] = sum_{b, t} y[b, o, t]^2,

returning (y in x.dtype, s fp32, ss fp32). ``batch_mean_var`` turns the
totals into flax's biased batch statistics.

Layout: the port's, not the JAX function's. x is [B, C, T] and w is
``Conv1d``'s [O, C, k] (the JAX function takes x [B, T, C] and w
[k, C, O]): every module of the port is [B, C, T], and the JAX layout here
would cost two transposes of the [B, T, C] activation (~112 MB each at the
paper shape) per layer per step. The tests transpose when they compare
with JAX.

On a CUDA tensor the forward launches the hand-written kernel of
``csrc/conv_stats.cu`` (design note there); on a CPU tensor it runs the
plain version, ``_reference_impl``. The backward mirrors the JAX custom
VJP (``_conv_stats_bwd``), which is plain XLA there and plain torch here:
fold the cotangents of s and ss into dY = dy + ds + 2 y dss in fp32, cast
to x.dtype, then dx is the transposed conv of dY and dw the weight
gradient (cuDNN on the card).
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from . import _build

#: time steps per block of the CUDA kernel (one workspace column tile)
_BT = 128
#: kernel widths the CUDA kernel is built for
_KERNEL_WIDTHS = (1, 3, 5, 7)


def _reference_impl(x: torch.Tensor, w: torch.Tensor, dilation: int
                    ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the conv on fp32 (a bf16 operand upcasts exactly),
    the two sums of the fp32 result, then y cast to x.dtype."""
    pad = (w.shape[2] // 2) * dilation
    y32 = F.conv1d(x.float(), w.float(), padding=pad, dilation=dilation)
    return y32.to(x.dtype), y32.sum(dim=(0, 2)), (y32 * y32).sum(dim=(0, 2))


def _launch(x: torch.Tensor, w: torch.Tensor, dilation: int
            ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel on contiguous fp32 or bf16 operands of one type."""
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"conv_stats takes fp32 or bf16 operands of one "
                        f"type, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv_stats needs contiguous operands")
    batch, channels, times = x.shape
    out_channels, _, k = w.shape
    if k not in _KERNEL_WIDTHS:
        raise ValueError(f"the conv_stats kernel takes k in "
                         f"{_KERNEL_WIDTHS}, got {k}")
    y = torch.empty((batch, out_channels, times), dtype=x.dtype,
                    device=x.device)
    s = torch.zeros(out_channels, dtype=torch.float32, device=x.device)
    ss = torch.zeros_like(s)
    if batch == 0 or times == 0 or out_channels == 0:
        return y, s, ss
    # the weights transposed to [C k, O rounded up to 4] fp32, then the
    # per-tile partial sums [2, column tiles, O]
    n_cols = batch * -(-times // _BT)
    workspace = torch.empty(channels * k * -(-out_channels // 4) * 4
                            + 2 * n_cols * out_channels,
                            dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.bm_conv_stats(
            x.data_ptr(), w.data_ptr(), int(x.dtype == torch.bfloat16),
            y.data_ptr(), workspace.data_ptr(), s.data_ptr(), ss.data_ptr(),
            batch, channels, times, out_channels, k, dilation,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_status("conv_stats", status)
    conv_stats.launches += 1
    return y, s, ss


class _ConvStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, dilation):
        if x.device.type == "cpu":
            y, s, ss = _reference_impl(x, w, dilation)
        elif x.device.type == "cuda":
            y, s, ss = _launch(x, w, dilation)
        else:
            raise ValueError(f"conv_stats runs on cpu or cuda, not "
                             f"{x.device}")
        ctx.save_for_backward(x, w, y)
        ctx.dilation = dilation
        # an unused output's gradient arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, ds, dss):
        x, w, y = ctx.saved_tensors
        d = ctx.dilation
        # fold the sums' cotangents into dY: s = sum y, ss = sum y^2
        dY = torch.zeros(y.shape, dtype=torch.float32, device=y.device) \
            if dy is None else dy.float()
        if ds is not None:
            dY = dY + ds[None, :, None]
        if dss is not None:
            dY = dY + 2.0 * y.float() * dss[None, :, None]
        dY = dY.to(x.dtype)
        pad = (w.shape[2] // 2) * d
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv1d_input(x.shape, w, dY, padding=pad,
                                            dilation=d)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(x, w.shape, dY, padding=pad,
                                             dilation=d)
        return dx, dw, None


def conv_stats(x: torch.Tensor, w: torch.Tensor, dilation: int = 1
               ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, C, T], w [O, C, k] (odd k) -> (y [B, O, T] in x.dtype,
    s [O] fp32, ss [O] fp32), differentiable in x and w. Operands are made
    contiguous first."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"conv_stats needs x [B, C, T] and w [O, C, k], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[2] % 2 != 1 or dilation < 1:
        raise ValueError(f"conv_stats needs an odd kernel and dilation >= "
                         f"1, got k={w.shape[2]}, dilation={dilation}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    return _ConvStats.apply(x.contiguous(), w.contiguous(), int(dilation))


#: kernel launches since the last reset (the CPU path does not count)
conv_stats.launches = 0


def batch_mean_var(s: torch.Tensor, ss: torch.Tensor, n: int
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Biased batch statistics from the per-channel totals (flax
    BatchNorm: var = E[y^2] - E[y]^2, clamped at 0)."""
    mean = s / n
    var = ss / n - mean * mean
    return mean, var.clamp(min=0.0)
