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
``csrc/conv_stats.cu`` (design note there), route "tc" for both types:
TMA-fed ``wgmma`` with the time tiles as the register-fed A operand and
the weights as the K-major B operand (``tc_operands``). fp32 runs as
three TF32 products, its weights split once per call into hi and lo TF32
halves (``split_weights``); bf16 runs one bf16 product, its weights
rearranged once per call. On a CPU tensor it runs the plain version,
``_reference_impl``. The backward mirrors the JAX custom
VJP (``_conv_stats_bwd``), which is plain XLA there and plain torch here:
fold the cotangents of s and ss into dY = dy + ds + 2 y dss in fp32, cast
to x.dtype, then dx is the transposed conv of dY and dw the weight
gradient (cuDNN on the card).
"""

from __future__ import annotations

import functools
import typing as tp

import torch
import torch.nn.functional as F

from . import _build
from .matmul import tma_operand

#: time steps per block (one workspace column tile)
_BT = 128
#: the types the kernel takes
TYPES = (torch.float32, torch.bfloat16)
#: output-channel tile widths (the wgmma N side), the bytes of a K step's
#: weight row (one 128-byte swizzle row: 32 fp32 or 64 bf16 input
#: channels), the x box's time steps, shared memory
TC_WIDTHS = (8, 64, 128, 160)
TC_ROW_BYTES = 128
_X_BOX_STEPS = _BT + 8
_SMEM_LIMIT = 232_448          # 227 KB per block
_MAX_STAGES = 8
#: TMA's row and innermost-coordinate alignment
_ALIGN_BYTES = 16


def _reference_impl(x: torch.Tensor, w: torch.Tensor, dilation: int
                    ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the conv on fp32 (a bf16 operand upcasts exactly),
    the two sums of the fp32 result, then y cast to x.dtype."""
    pad = (w.shape[2] // 2) * dilation
    y32 = F.conv1d(x.float(), w.float(), padding=pad, dilation=dilation)
    return y32.to(x.dtype), y32.sum(dim=(0, 2)), (y32 * y32).sum(dim=(0, 2))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 values by integer ops: keep 10
    mantissa bits, rounding half away from zero (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def weight_taps(w: torch.Tensor) -> torch.Tensor:
    """w [O, C, k] -> [k, O, C_pad] in w's type, one copy: C contiguous
    (K-major) and zero-padded to a multiple of 16 bytes (TMA's rows), C4
    in fp32 and C8 in bf16. The bf16 B operand as it is."""
    multiple = _ALIGN_BYTES // w.element_size()
    return F.pad(w.permute(2, 0, 1), (0, -w.shape[1] % multiple)).contiguous()


def split_weights(w: torch.Tensor) -> torch.Tensor:
    """w [O, C, k] fp32 -> [2 k, O, C4] fp32, the fp32 B operand: taps j <
    k hold hi = rna_tf32(w[:, :, j]), taps k + j hold lo = rna_tf32(w -
    hi), each ``weight_taps``' [O, C4].

    On a CUDA tensor the split is ``split_tf32`` of ``csrc/sm90.cuh`` (one
    launch), on a CPU tensor its plain version, ``round_tf32``."""
    taps = weight_taps(w)
    if taps.device.type == "cpu":
        hi = round_tf32(taps)
        return torch.cat([hi, round_tf32(taps - hi)])
    out = torch.empty((2 * taps.shape[0],) + taps.shape[1:],
                      dtype=torch.float32, device=taps.device)
    with torch.cuda.device(taps.device):
        status = _build.library().bm_split_tf32(
            taps.data_ptr(), out.data_ptr(), out[taps.shape[0]:].data_ptr(),
            taps.numel() // 4,
            torch.cuda.current_stream(taps.device).cuda_stream)
    _build.check_status("split_tf32", status)
    return out


def tc_operands(x: torch.Tensor, w: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operands: x [B, C, T] as [B, C, T_pad] with T_pad = T
    rounded up to 16 bytes, T4 fp32 or T8 bf16 (zero columns, a copy only
    when T is not a multiple or x is misaligned), and the weights as the B
    operand: fp32 split [2 k, O, C4], bf16 taps [k, O, C8]."""
    batch, channels, times = x.shape
    x_pad = tma_operand(x.view(batch * channels, times))
    w_op = split_weights(w) if w.dtype == torch.float32 else weight_taps(w)
    return x_pad.view(batch, channels, -1), w_op


@functools.lru_cache(maxsize=64)
def plan_tc(out_channels: int, dtype: torch.dtype = torch.float32
            ) -> tp.Tuple[int, int, int]:
    """(width, stages, shared memory bytes) of the kernel in `dtype`.

    width is the smallest of TC_WIDTHS that covers `out_channels`, the
    widest (160: two tiles at the paper's 320) above that. A stage holds
    the x box [channels][136 steps] and the weights' tiles [width][channels]
    of 128-byte rows: hi and lo in fp32, one in bf16. The ring takes as
    many stages as fit in 227 KB beside 1024 bytes of alignment slack, 16
    bytes of barriers a stage and the epilogue's [2][8 warps][width] sums,
    at most 8."""
    width = next((w for w in TC_WIDTHS if w >= out_channels), TC_WIDTHS[-1])
    tiles = 2 if dtype == torch.float32 else 1
    stage = TC_ROW_BYTES * (_X_BOX_STEPS + tiles * width)
    sums = 2 * 8 * width * 4
    stages = min(_MAX_STAGES, (_SMEM_LIMIT - 1024 - sums) // (stage + 16))
    return width, stages, 1024 + stages * (stage + 16) + sums


def _tc_kernel(x_pad: torch.Tensor, w_op: torch.Tensor, y: torch.Tensor,
               s: torch.Tensor, ss: torch.Tensor, dilation: int) -> None:
    """The kernel (and its column sums) alone, on the operands
    ``tc_operands`` gives, into y [B, O, T], s and ss [O]."""
    batch, channels, times_pad = x_pad.shape
    _, out_channels, times = y.shape
    bf16 = x_pad.dtype == torch.bfloat16
    width, stages, _ = plan_tc(out_channels, x_pad.dtype)
    # the per-tile partial sums [2, column tiles, O]
    workspace = torch.empty(2 * batch * -(-times // _BT) * out_channels,
                            dtype=torch.float32, device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        status = _build.library().bm_conv_stats_tc(
            x_pad.data_ptr(), w_op.data_ptr(), int(bf16), y.data_ptr(),
            workspace.data_ptr(), s.data_ptr(), ss.data_ptr(), batch,
            channels, times, times_pad, out_channels,
            w_op.shape[0] // (1 if bf16 else 2), dilation, width, stages,
            torch.cuda.current_stream(x_pad.device).cuda_stream)
    _build.check_status("conv_stats", status)


def _check_route(dtype: torch.dtype, k: int) -> str:
    """The route of a `dtype` operand, "tc" (the tensor cores) for fp32
    and bf16, after checking that it takes width `k`: any odd k."""
    if dtype not in TYPES:
        raise TypeError(f"conv_stats takes fp32 or bf16, got {dtype}")
    if k < 1 or k % 2 == 0:
        name = "fp32" if dtype == torch.float32 else "bf16"
        raise ValueError(f"conv_stats' {name} route (tensor cores) takes "
                         f"an odd k >= 1, got {k}")
    return "tc"


def _launch(x: torch.Tensor, w: torch.Tensor, dilation: int
            ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel on contiguous fp32 or bf16 operands of one type."""
    if x.dtype not in TYPES or w.dtype != x.dtype:
        raise TypeError(f"conv_stats takes fp32 or bf16 operands of one "
                        f"type, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv_stats needs contiguous operands")
    batch, channels, times = x.shape
    out_channels, _, k = w.shape
    route = _check_route(x.dtype, k)
    if dilation < 1:
        raise ValueError(f"conv_stats needs dilation >= 1, got {dilation}")
    y = torch.empty((batch, out_channels, times), dtype=x.dtype,
                    device=x.device)
    s = torch.zeros(out_channels, dtype=torch.float32, device=x.device)
    ss = torch.zeros_like(s)
    if batch == 0 or times == 0 or out_channels == 0:
        return y, s, ss
    if channels == 0:
        return y.zero_(), s, ss
    _tc_kernel(*tc_operands(x, w), y, s, ss, dilation)
    conv_stats.launches += 1
    conv_stats.launches_by_route[route] += 1
    conv_stats.launches_by_dtype[str(x.dtype).split(".")[-1]] += 1
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


#: kernel launches since the last reset (the CPU path does not count), in
#: all, by route and by operand type
conv_stats.launches = 0
conv_stats.launches_by_route = {"tc": 0}
conv_stats.launches_by_dtype = {"float32": 0, "bfloat16": 0}


def batch_mean_var(s: torch.Tensor, ss: torch.Tensor, n: int
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Biased batch statistics from the per-channel totals (flax
    BatchNorm: var = E[y^2] - E[y]^2, clamped at 0)."""
    mean = s / n
    var = ss / n - mean * mean
    return mean, var.clamp(min=0.0)
