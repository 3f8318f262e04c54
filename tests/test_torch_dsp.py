"""The port's DSP (brainmagick_tpu_torch.ops.dsp) against the committed
float64 goldens at tests/test_dsp_goldens.py's tolerances, and against
the JAX package's functions on the same numpy inputs: equal output
lengths, and values within 1e-5 of max|x|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_dsp_goldens import GOLDEN, LOWPASS_CASES, RESAMPLE_CASES

from brainmagick_tpu.ops import dsp as jdsp
from brainmagick_tpu_torch.ops import dsp

#: the port's agreement with the JAX functions, as a share of max|x|
REL_TOL = 1e-5


def _port(fn, x, *args, **kwargs):
    return fn(torch.from_numpy(np.ascontiguousarray(x)), *args,
              **kwargs).numpy()


def _close_to_jax(got, want, x, what=""):
    """Equal shapes, and the error within REL_TOL of max|x| (printed, for
    ``pytest -s``)."""
    assert got.shape == want.shape
    err = np.abs(got - np.asarray(want)).max() / np.abs(x).max()
    print(f"{what} {list(x.shape)}: max |port - jax| / max|x| = {err:.2e}")
    assert err <= REL_TOL, err


def test_dsp_version_is_the_jax_packages():
    assert dsp.DSP_VERSION == jdsp.DSP_VERSION


@pytest.mark.parametrize("old,new,n", RESAMPLE_CASES)
@pytest.mark.parametrize("full", [False, True], ids=["floor", "ceil"])
def test_resample_matches_golden(old, new, n, full):
    golden = np.load(GOLDEN)
    x = golden[f"rs_{old}_{new}_in"]
    want = golden[f"rs_{old}_{new}_out" + ("_full" if full else "")]
    got = _port(dsp.resample, x, old, new, full=full)
    assert got.shape == want.shape, "output-length convention drifted"
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("cutoff,zeros,n", LOWPASS_CASES)
def test_lowpass_matches_golden(cutoff, zeros, n):
    golden = np.load(GOLDEN)
    x = golden[f"lp_{zeros}_{n}_in"]
    got = _port(dsp.lowpass_filter, x, cutoff, zeros=zeros)
    np.testing.assert_allclose(got, golden[f"lp_{zeros}_{n}_out"],
                               atol=3e-5, rtol=3e-5)


def test_highpass_matches_golden():
    golden = np.load(GOLDEN)
    cutoff, zeros, n = LOWPASS_CASES[1]
    x = golden[f"lp_{zeros}_{n}_in"]
    want = x.astype(np.float64) - golden[f"lp_{zeros}_{n}_out"]
    got = _port(dsp.highpass_filter, x, cutoff, zeros=zeros)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("old,new,n", RESAMPLE_CASES + [(1200, 120, 12_000),
                                                        (16_000, 16_000, 9)])
@pytest.mark.parametrize("full", [False, True], ids=["floor", "ceil"])
def test_resample_matches_jax(old, new, n, full):
    """Batched [8, n] (and [2, 4, n] leading dims), including the fake
    study's 1200 -> 120 Hz at 12,000 samples."""
    x = np.random.RandomState(n).randn(8, n).astype(np.float32) * 3
    want = jdsp.resample(jnp.asarray(x), old, new, full=full)
    what = f"resample {old} -> {new} Hz, full={full}"
    _close_to_jax(_port(dsp.resample, x, old, new, full=full), want, x,
                  what)
    got = _port(dsp.resample, x.reshape(2, 4, n), old, new, full=full)
    _close_to_jax(got, np.asarray(want).reshape(got.shape), x, what)


@pytest.mark.parametrize("cutoff,zeros", [(30 / 120, 5), (0.5 / 120, 8),
                                          (10 / 120, 5), (0.6, 5)])
def test_filters_match_jax(cutoff, zeros):
    """lowpass and highpass of [8, 1200] (a cutoff past Nyquist is the
    identity in both)."""
    x = np.random.RandomState(3).randn(8, 1200).astype(np.float32)
    for port_fn, jax_fn in ((dsp.lowpass_filter, jdsp.lowpass_filter),
                            (dsp.highpass_filter, jdsp.highpass_filter)):
        want = jax_fn(jnp.asarray(x), cutoff, zeros=zeros)
        _close_to_jax(_port(port_fn, x, cutoff, zeros=zeros), want, x,
                      f"{port_fn.__name__} {cutoff:.4f}, zeros={zeros}")


def test_filter_banks_equal_the_jax_packages():
    """The numpy designs are the JAX package's, bit for bit."""
    for case in [(1200, 120, 24, 0.945), (44_100, 16_000, 24, 0.945)]:
        got, width = dsp._resample_kernel(*case)
        want, jwidth = jdsp._resample_kernel(*case)
        assert width == jwidth
        np.testing.assert_array_equal(got, np.asarray(want))
    got, half = dsp._lowpass_kernel(30 / 120, 5)
    want = jdsp._lowpass_kernel(30 / 120, 5)
    assert half == want[1]
    np.testing.assert_array_equal(got.reshape(-1),
                                  np.asarray(want[0]).reshape(-1))


def test_dsp_runs_in_exact_fp32():
    """The filters turn TF32 off while they run and restore the caller's
    flags after."""
    seen = []
    conv1d = torch.nn.functional.conv1d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return conv1d(*args, **kwargs)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        torch.nn.functional.conv1d = spy
        x = torch.randn(2, 600)
        dsp.resample(x, 1200, 120)
        dsp.lowpass_filter(x, 0.1)
    finally:
        torch.nn.functional.conv1d = conv1d
        assert torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = before
    assert seen == [(False, False)] * 2


@pytest.mark.parametrize("offset_ms", [0., 50.])
def test_task_lowpass_matches_jax(offset_ms):
    """``task.lowpass`` (a zero-phase FIR of the MEG, 5 zero crossings a
    side) in the solver's task wiring, after the MEG offset, against the
    JAX solver's on the same [B, C, T] arrays."""
    import types

    from brainmagick_tpu.config import MainConfig
    from brainmagick_tpu.solver import Solver as JaxSolver
    from brainmagick_tpu_torch.solver import Solver

    args = MainConfig()
    args.task.lowpass = 10.
    args.task.offset_meg_ms = offset_ms
    rng = np.random.RandomState(0)
    meg = rng.randn(3, 5, 361).astype(np.float32)
    features = rng.randn(3, 4, 361).astype(np.float32)
    mask = np.ones((3, 1, 361), dtype=bool)
    jself = types.SimpleNamespace(args=args)
    jself._offsets = lambda: JaxSolver._offsets(jself)
    inputs, output, _, _ = JaxSolver._task_wiring(
        jself, jnp.asarray(meg), jnp.asarray(features), jnp.asarray(mask))
    pself = types.SimpleNamespace(args=args)
    pself._offsets = lambda: Solver._offsets(pself)
    got, got_output, _ = Solver._task_wiring(
        pself, torch.from_numpy(meg), torch.from_numpy(features),
        torch.from_numpy(mask))
    _close_to_jax(got["meg"].numpy(), inputs["meg"], meg, "task.lowpass")
    np.testing.assert_array_equal(got_output.numpy(), np.asarray(output))
    assert got["meg"].shape[-1] == 361 - int(offset_ms * 120 / 1000)
