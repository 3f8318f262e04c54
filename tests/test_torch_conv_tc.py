"""The tensor-core route of conv_stats (csrc/conv_stats.cu, conv_stats_tc)
on the CPU: a numpy model of its fp32 arithmetic against the JAX package's
conv_stats, the host-side operands it is given in fp32 and bf16 (padded x,
split or rearranged weights), its tile planner, and the checks the wrapper
makes before it touches the card. The kernel itself runs only on the card
(chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainmagick_tpu.ops import pallas_conv_bn as jconv
from brainmagick_tpu_torch import ops
from brainmagick_tpu_torch.ops import _build, conv_bn

#: the kernel's error budget: each error over its Cauchy-Schwarz bound
MODEL_TOL = 1e-6


def _round_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 by integer ops on uint32 (an independent copy of
    the rounding the wrapper does in torch)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _kernel_model(x4: np.ndarray, w_split: np.ndarray, times: int,
                  dilation: int) -> tuple:
    """conv_stats_tc's arithmetic on the operands the wrapper gives it:
    for each K step (tap j, block of 32 channels), x's hi and lo TF32
    halves against the hi and lo weights, a_lo b_hi + a_hi b_lo + a_hi
    b_hi (exact products, summed in fp64 and rounded to fp32: the step's
    fresh accumulator), folded into the running fp32 sum. Returns y
    [B, O, T] fp32 and the fp64 sums of y and y^2."""
    batch, channels, _ = x4.shape
    k = w_split.shape[0] // 2
    w_hi, w_lo = (w_split[:k, :, :channels].astype(np.float64),
                  w_split[k:, :, :channels].astype(np.float64))
    pad = (k // 2) * dilation
    # x[b, c, t + j d - pad] for t < T, zero outside [0, T4)
    padded = np.zeros((batch, channels, times + 2 * pad), np.float32)
    width = min(x4.shape[2], times + pad)
    padded[:, :, pad:pad + width] = x4[:, :, :width]
    y = np.zeros((batch, w_split.shape[1], times), np.float32)
    for j in range(k):
        xj = padded[:, :, j * dilation:j * dilation + times]
        x_hi = _round_tf32(xj)
        x_lo = _round_tf32(xj - x_hi)
        x_hi, x_lo = x_hi.astype(np.float64), x_lo.astype(np.float64)
        block = conv_bn.TC_ROW_BYTES // 4         # a K step: 32 channels
        for c0 in range(0, channels, block):
            c = slice(c0, c0 + block)
            step = (np.einsum("oc,bct->bot", w_hi[j, :, c], x_lo[:, c])
                    + np.einsum("oc,bct->bot", w_lo[j, :, c], x_hi[:, c])
                    + np.einsum("oc,bct->bot", w_hi[j, :, c], x_hi[:, c]))
            y = (y + step.astype(np.float32)).astype(np.float32)
    y64 = y.astype(np.float64)
    return y, y64.sum(axis=(0, 2)), (y64 * y64).sum(axis=(0, 2))


def _operands(B, C, O, T, k, seed, one_sign=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, T).astype(np.float32)
    w = (rng.randn(O, C, k) / np.sqrt(C * k)).astype(np.float32)
    if one_sign:
        x, w = np.abs(x), np.abs(w)
    return x, w


def _bounds(x, w, dilation):
    """|w_o| |x window| per output, [B, O, T], in fp64."""
    k = w.shape[2]
    pad = (k // 2) * dilation
    sq = np.pad(x.astype(np.float64) ** 2, ((0, 0), (0, 0), (pad, pad)))
    times = x.shape[2]
    window = sum(sq[:, :, j * dilation:j * dilation + times]
                 for j in range(k)).sum(axis=1)                 # [B, T]
    w_norm = np.linalg.norm(w.astype(np.float64).reshape(len(w), -1), axis=1)
    return w_norm[None, :, None] * np.sqrt(window)[:, None, :]


@pytest.mark.parametrize("one_sign", [False, True], ids=["normal",
                                                         "one_sign"])
@pytest.mark.parametrize("dilation", [1, 4, 16])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11])
def test_kernel_model_matches_jax(k, dilation, one_sign):
    """The model of the tensor-core route, on the operands the wrapper
    builds (T = 37 padded to 40; C = 40 in two channel blocks, the second
    ragged), within MODEL_TOL of the Cauchy-Schwarz bound of the JAX
    package's conv_stats (its XLA path) and of the exact conv: y over
    |w_o| |x window|, s and ss over the sums of that bound and of its
    square."""
    B, C, O, T = 2, 40, 24, 37
    x, w = _operands(B, C, O, T, k, seed=10 * k + dilation,
                     one_sign=one_sign)
    x4, w_split = conv_bn.tc_operands(torch.from_numpy(x),
                                      torch.from_numpy(w))
    assert x4.shape == (B, C, 40)
    y, s, ss = _kernel_model(x4.numpy(), w_split.numpy(), T, dilation)
    bound = _bounds(x, w, dilation)
    xj = jnp.asarray(np.swapaxes(x, 1, 2))
    wj = jnp.asarray(np.transpose(w, (2, 1, 0)))
    want_y, want_s, want_ss = jconv.conv_stats(xj, wj, dilation, "xla")
    exact = torch.nn.functional.conv1d(
        torch.from_numpy(x).double(), torch.from_numpy(w).double(),
        padding=(k // 2) * dilation, dilation=dilation).numpy()
    for ref_y, ref_s, ref_ss in (
            (np.swapaxes(np.asarray(want_y), 1, 2), np.asarray(want_s),
             np.asarray(want_ss)),
            (exact, exact.sum(axis=(0, 2)), (exact ** 2).sum(axis=(0, 2)))):
        assert (np.abs(y - ref_y) / bound).max() <= MODEL_TOL
        assert (np.abs(s - ref_s) / bound.sum(axis=(0, 2))).max() \
            <= MODEL_TOL
        assert (np.abs(ss - ref_ss) / (bound ** 2).sum(axis=(0, 2))).max() \
            <= MODEL_TOL


@pytest.mark.parametrize("shape", [(5, 3, 1), (24, 40, 3), (320, 270, 3),
                                   (7, 33, 7)], ids=str)
def test_split_weights_exact(shape):
    """The wrapper's split is the model's, bit for bit: [2 k, O, C4] with
    hi taps then lo taps, C contiguous, zero past C; hi + lo is w to
    2^-21 of |w| (TF32's 11-bit significands, twice)."""
    O, C, k = shape
    w = (np.random.RandomState(O).randn(O, C, k) * 3).astype(np.float32)
    got = conv_bn.split_weights(torch.from_numpy(w)).numpy()
    c4 = -(-C // 4) * 4
    assert got.shape == (2 * k, O, c4) and got.dtype == np.float32
    taps = np.transpose(w, (2, 0, 1))
    hi = _round_tf32(taps)
    lo = _round_tf32(taps - hi)
    np.testing.assert_array_equal(got[:k, :, :C].view(np.uint32),
                                  hi.view(np.uint32))
    np.testing.assert_array_equal(got[k:, :, :C].view(np.uint32),
                                  lo.view(np.uint32))
    assert not got[:, :, C:].any()
    assert (got[:k].view(np.uint32) & 0x1FFF).max() == 0
    assert (np.abs(got[:k, :, :C].astype(np.float64) + got[k:, :, :C]
                   - taps) <= 2.0 ** -21 * np.abs(taps)).all()


def test_round_tf32_rounds_half_away_from_zero():
    """Ties go away from zero in magnitude for either sign, below a tie
    rounds down, and the result keeps 10 mantissa bits."""
    one = np.float32(1.0).view(np.uint32)
    ulp13 = np.array([one + 0x1000, one + 0x0FFF, one + 0x3000,
                      one + 0x1FFF], np.uint32).view(np.float32)
    values = np.concatenate([ulp13, -ulp13, [0.0, -0.0, 3.0e-39, 1e30]])
    values = values.astype(np.float32)
    got = conv_bn.round_tf32(torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _round_tf32(values).view(np.uint32))
    step = np.float32(2.0 ** -10)
    np.testing.assert_array_equal(got[:4], [1 + step, 1, 1 + 2 * step,
                                            1 + step])
    np.testing.assert_array_equal(got[4:8], -got[:4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(5, 3, 1), (24, 40, 3), (320, 270, 3),
                                   (7, 33, 9)], ids=str)
def test_weight_taps_layout(shape, dtype):
    """weight_taps is w as [k, O, C_pad] in its own type, bit for bit: tap
    j holds w[:, :, j] with C contiguous, zero from C to C4 (fp32) or C8
    (bf16), the 16 bytes TMA needs; bf16's B operand is this, fp32's the
    split of it."""
    O, C, k = shape
    w = torch.from_numpy(np.random.RandomState(O).randn(O, C, k)
                         .astype(np.float32)).to(dtype)
    got = conv_bn.weight_taps(w)
    pad = -(-C // (16 // dtype.itemsize)) * (16 // dtype.itemsize)
    assert got.shape == (k, O, pad) and got.dtype == dtype
    assert got.is_contiguous()
    assert torch.equal(got[:, :, :C], w.permute(2, 0, 1))
    assert not got[:, :, C:].any()
    x = torch.zeros(1, C, 5, dtype=dtype)
    assert torch.equal(conv_bn.tc_operands(x, w)[1],
                       got if dtype == torch.bfloat16
                       else conv_bn.split_weights(w))


#: output channels the planner is checked at
PLAN_CHANNELS = [1, 5, 8, 9, 33, 64, 65, 72, 128, 129, 161, 200, 256, 320,
                 1024]


def _check_plan(out_channels, dtype):
    """The planner's width is a wgmma N (a multiple of 8, at most 256) from
    TC_WIDTHS, the smallest that covers the output channels or else the
    widest, its tiles cover them with less than one tile to spare, and the
    ring of at least two stages, the barriers and the epilogue's sums fit
    the 227 KB a block can have, with no room for one more stage below the
    cap of 8. A stage holds one tap's x box and weight tiles of 128-byte
    rows (hi and lo in fp32, one in bf16), so the plan is the same for
    every k. At the paper's 320 channels: two tiles of 160, no padding,
    and five stages in bf16."""
    width, stages, smem = conv_bn.plan_tc(out_channels, dtype)
    assert width in conv_bn.TC_WIDTHS and width % 8 == 0 and width <= 256
    tiles = -(-out_channels // width)
    assert (tiles - 1) * width < out_channels <= tiles * width
    weight_tiles = 2 if dtype == torch.float32 else 1
    stage = 128 * (136 + weight_tiles * width)
    assert 2 <= stages <= 8
    assert smem == 1024 + stages * (stage + 16) + 64 * width
    assert smem <= 232_448
    assert stages == 8 or smem + stage + 16 > 232_448
    covering = [w for w in conv_bn.TC_WIDTHS if w >= out_channels]
    assert width == (covering[0] if covering else conv_bn.TC_WIDTHS[-1])
    if out_channels == 320:
        assert (width, tiles) == (160, 2)
        assert dtype == torch.float32 or stages == 5


@pytest.mark.parametrize("out_channels", PLAN_CHANNELS)
def test_plan_tc_tiles_and_fits(out_channels):
    """``_check_plan`` in fp32 (the planner's default type)."""
    _check_plan(out_channels, torch.float32)
    assert conv_bn.plan_tc(out_channels) == conv_bn.plan_tc(out_channels,
                                                           torch.float32)


@pytest.mark.parametrize("out_channels", PLAN_CHANNELS)
def test_plan_tc_bf16_tiles_and_fits(out_channels):
    """``_check_plan`` in bf16: one weight tile a stage."""
    _check_plan(out_channels, torch.bfloat16)


def _check_pad(times, dtype):
    """x is padded in T to 16 bytes (T4 fp32, T8 bf16), copied only then;
    the weights become the type's B operand."""
    x = torch.randn(2, 3, times).to(dtype)
    w = torch.randn(4, 3, 3).to(dtype)
    x_pad, w_op = conv_bn.tc_operands(x, w)
    multiple = 16 // dtype.itemsize
    assert x_pad.shape == (2, 3, times + (-times % multiple))
    assert x_pad.dtype == w_op.dtype == dtype
    assert torch.equal(x_pad[:, :, :times], x)
    assert not x_pad[:, :, times:].any()
    assert (x_pad.data_ptr() == x.data_ptr()) == (times % multiple == 0)
    assert w_op.shape == ((6, 4, 4) if dtype == torch.float32 else (3, 4, 8))


@pytest.mark.parametrize("times", [1, 4, 37, 343, 344])
def test_tc_operands_pad_time_only_when_needed(times):
    _check_pad(times, torch.float32)


@pytest.mark.parametrize("times", [1, 4, 8, 37, 343, 344])
def test_tc_operands_bf16_pad_time_only_when_needed(times):
    _check_pad(times, torch.bfloat16)


def test_launch_refuses_what_the_kernels_do_not_take():
    """The wrapper raises before it builds or touches anything: other
    types, mixed types, non-contiguous operands, an even width in either
    type, and dilation < 1."""
    x, w = torch.zeros(1, 2, 5), torch.zeros(4, 2, 3)
    cases = [((x.half(), w.half(), 1), TypeError, "fp32 or bf16"),
             ((x, w.bfloat16(), 1), TypeError, "one type"),
             ((x.transpose(1, 2).contiguous().transpose(1, 2), w, 1),
              ValueError, "contiguous"),
             ((x.bfloat16(), torch.zeros(4, 2, 2).bfloat16(), 1),
              ValueError, r"bf16 route \(tensor cores\) takes an odd k"),
             ((x, torch.zeros(4, 2, 2), 1), ValueError,
              r"fp32 route \(tensor cores\) takes an odd k"),
             ((x, w, 0), ValueError, "dilation")]
    for args, error, match in cases:
        with pytest.raises(error, match=match):
            conv_bn._launch(*args)


def test_check_route_by_dtype():
    """fp32 and bf16 both go to the tensor cores ("tc") at any odd k, 9
    and 11 included, and an even or non-positive width is refused with the
    type's route named."""
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for k in (1, 3, 9, 11, 31):
            assert conv_bn._check_route(dtype, k) == "tc"
        for k in (0, 2, -1):
            with pytest.raises(ValueError, match=f"{name} route"):
                conv_bn._check_route(dtype, k)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        conv_bn._check_route(torch.float16, 3)


def test_route_counts_reset_with_the_launch_counts():
    conv_bn.conv_stats.launches_by_route["tc"] += 3
    conv_bn.conv_stats.launches_by_dtype["bfloat16"] += 3
    conv_bn.conv_stats.launches += 3
    ops.reset_launch_counts()
    assert conv_bn.conv_stats.launches == 0
    assert conv_bn.conv_stats.launches_by_route == {"tc": 0}
    assert conv_bn.conv_stats.launches_by_dtype == {"float32": 0,
                                                    "bfloat16": 0}
    # the CPU path runs the plain version and counts nothing
    conv_bn.conv_stats(torch.randn(1, 2, 5), torch.randn(3, 2, 3))
    conv_bn.conv_stats(torch.randn(1, 2, 5).bfloat16(),
                       torch.randn(3, 2, 9).bfloat16())
    assert conv_bn.conv_stats.launches_by_route == {"tc": 0}
    assert conv_bn.conv_stats.launches_by_dtype == {"float32": 0,
                                                    "bfloat16": 0}


def test_kernel_signature_takes_both_types():
    """bm_conv_stats_tc is the one C entry of conv_stats: it takes the
    type as an int beside the operands, and the SIMT entry is gone."""
    argtypes, restype = _build.SIGNATURES["bm_conv_stats_tc"]
    assert len(argtypes) == 17 and argtypes[2] is _build.ctypes.c_int
    assert restype is _build.ctypes.c_int
    assert not any("bf16" in name for name in _build.SIGNATURES
                   if name.startswith("bm_conv_stats"))
    source = (_build.CSRC_DIR / "conv_stats.cu").read_text()
    assert "conv_stats_simt" not in source
    assert "bm_conv_stats_bf16" not in source


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header names a new library, as an edited
    source does, so a stale build is never loaded."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.library_path()
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, _build.library_path()}) == 3
    assert [p.name for p in _build._sources()] == ["a.cu"]
