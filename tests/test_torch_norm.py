"""The port's normalize_clamp_peak with the gathers and the bf16 upcast
folded in (brainmagick_tpu_torch/ops/norm.py), on the CPU: its plain path
with rec tables, bf16 input, NaN and inf, and indices out of range,
against the JAX package's normalize_clamp_peak (its XLA reference and its
Pallas kernel in interpret mode) on center[rec] and scale[rec] gathered as
the JAX solver gathers them; and the host side of the CUDA kernel
(csrc/normalize.cu): its division by magic numbers, its block planner,
its C signature. The kernel itself runs only on the card (chip_smoke.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from brainmagick_tpu.ops import pallas_norm
from brainmagick_tpu_torch.ops import _build, norm

LIMIT = 2.5
CSRC = Path(norm.__file__).resolve().parent.parent / "csrc"


def _case(B, C, T, R, seed):
    rng = np.random.RandomState(seed)
    meg = (rng.randn(B, C, T) * 4).astype(np.float32)
    center = rng.randn(R, C).astype(np.float32)
    scale = (0.5 + rng.rand(R, C)).astype(np.float32)
    return meg, center, scale


def _jax(meg, center, scale, clip):
    """The JAX function on gathered [B, C] tables: its XLA reference, and
    its Pallas kernel in interpret mode where it runs (with the clamp)."""
    args = (jnp.asarray(meg), jnp.asarray(center), jnp.asarray(scale), LIMIT)
    want = [pallas_norm._reference_impl(*args, clip=clip)]
    if clip:
        want.append(pallas_norm.normalize_clamp_peak(*args, clip=True,
                                                     interpret=True))
    return [(np.asarray(o), np.asarray(p)) for o, p in want]


def _port(meg, center, scale, clip, rec=None, dtype=torch.float32):
    out, peak = norm.normalize_clamp_peak(
        torch.from_numpy(meg).to(dtype), torch.from_numpy(center),
        torch.from_numpy(scale), LIMIT, clip=clip,
        rec=None if rec is None else torch.from_numpy(rec))
    assert out.dtype == peak.dtype == torch.float32
    return out.numpy(), peak.numpy()


def _assert_matches(got, want):
    for out_j, peak_j in want:
        np.testing.assert_allclose(got[0], out_j, atol=1e-6)
        np.testing.assert_allclose(got[1], peak_j, atol=1e-6)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("rec", [[2, 0, 2, 1, 3, 3], [3, 2, 1, 0, 0, 1],
                                 [1, 1, 1, 1, 1, 1]],
                         ids=["repeated", "unordered", "one_recording"])
def test_rec_tables_match_jax(rec, clip):
    """rec [B] into [R, C] tables against JAX on center[rec] and
    scale[rec] gathered in numpy; the same as the port's own call on the
    gathered tables, bit for bit."""
    rec = np.array(rec, np.int64)
    meg, center, scale = _case(len(rec), 7, 33, 4, seed=rec.sum())
    got = _port(meg, center, scale, clip, rec)
    _assert_matches(got, _jax(meg, center[rec], scale[rec], clip))
    gathered = _port(meg, center[rec], scale[rec], clip)
    for g, w in zip(got, gathered):
        np.testing.assert_array_equal(g, w)
    assert got[1].max() > LIMIT


@pytest.mark.parametrize("rec", [None, [0, 3, 1]], ids=["gathered", "rec"])
@pytest.mark.parametrize("clip", [True, False])
def test_bf16_meg_matches_jax_on_its_upcast(clip, rec):
    """bf16 meg (the wire format) is read as it is: the JAX function on
    its exact fp32 upcast gives the same result."""
    meg, center, scale = _case(3, 5, 19, 4 if rec else 3, seed=5)
    meg16 = meg.astype(ml_dtypes.bfloat16)
    out, peak = norm.normalize_clamp_peak(
        torch.from_numpy(meg).bfloat16(), torch.from_numpy(center),
        torch.from_numpy(scale), LIMIT, clip=clip,
        rec=None if rec is None else torch.tensor(rec))
    np.testing.assert_array_equal(
        torch.from_numpy(meg).bfloat16().float().numpy(),
        meg16.astype(np.float32))
    index = np.arange(3) if rec is None else np.array(rec)
    _assert_matches((out.numpy(), peak.numpy()),
                    _jax(meg16.astype(np.float32), center[index],
                         scale[index], clip))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [True, False])
def test_nan_and_inf_match_jax(clip, dtype):
    """A NaN and a +-inf in one row, an inf alone in another: the row's
    peak is NaN (NaN beats inf), the other's inf; the NaN stays NaN
    through the clamp and inf goes to +-limit, as in JAX."""
    meg, center, scale = _case(3, 4, 9, 3, seed=11)
    meg[0, 1, 2] = np.nan
    meg[0, 3, 8] = np.inf
    meg[0, 0, 0] = -np.inf
    meg[1, 2, 5] = np.inf
    if dtype == "bfloat16":  # values bf16 holds exactly
        meg = meg.astype(ml_dtypes.bfloat16).astype(np.float32)
    rec = np.array([2, 0, 1])
    got = _port(meg, center, scale, clip, rec, getattr(torch, dtype))
    _assert_matches(got, _jax(meg, center[rec], scale[rec], clip))
    out, peak = got
    assert np.isnan(peak[0]) and peak[1] == np.inf and np.isfinite(peak[2])
    assert np.isnan(out[0, 1, 2]) and np.isnan(out).sum() == 1
    if clip:
        assert (out[0, 3, 8], out[0, 0, 0], out[1, 2, 5]) == (LIMIT, -LIMIT,
                                                             LIMIT)
    else:
        assert np.isinf(out).sum() == 3
    # norm.clip=False rejects a sample whose peak is not <= limit
    assert not (peak <= LIMIT)[:2].any()


def test_index_out_of_range_follows_the_jax_gather():
    """The JAX solver's gather na["meg_center"][rec]: a negative index
    counts from the end, then every index is clamped into [0, R). The
    port's plain version (gather_index) never reads outside the tables;
    chip_smoke.py holds the kernel to it with indices past both ends."""
    R = 4
    rec = np.array([-1, -4, -5, -100, 0, 3, 4, 7, 100], np.int64)
    meg, center, scale = _case(len(rec), 3, 6, R, seed=2)
    jax_rows = np.asarray(jnp.asarray(np.arange(R))[jnp.asarray(rec)])
    np.testing.assert_array_equal(jax_rows, [3, 0, 0, 0, 0, 3, 3, 3, 3])
    np.testing.assert_array_equal(
        norm.gather_index(torch.from_numpy(rec), R).numpy(), jax_rows)
    jax_center = np.asarray(jnp.asarray(center)[jnp.asarray(rec)])
    jax_scale = np.asarray(jnp.asarray(scale)[jnp.asarray(rec)])
    for clip in (True, False):
        _assert_matches(_port(meg, center, scale, clip, rec),
                        _jax(meg, jax_center, jax_scale, clip))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 64, 273, 343, 361, 1000, 4097,
                               98_553, 2 ** 20 + 1, 2 ** 30, 2 ** 31 - 1])
def test_divider_is_exact_below_2_31(d):
    """The kernel's channel index n // T as (n * magic) >> shift, in 64
    bits as the kernel computes it, for offsets around every multiple of d
    it can meet and at the top of the range; magic fits 32 bits."""
    magic, shift = norm.divider(d)
    assert 0 < magic < 2 ** 32
    top = 2 ** 31 - 1
    multiples = np.unique(np.concatenate([
        np.arange(0, min(top, 200 * d), d), np.arange(top // d, 0, -1)[:200]
        * d, np.random.RandomState(d).randint(0, top // d + 1, 500) * d]))
    n = np.unique(np.concatenate([multiples - 1, multiples, multiples + 1,
                                  [top, top - 1]]))
    n = n[(n >= 0) & (n <= top)].astype(np.uint64)
    got = (n * np.uint64(magic)) >> np.uint64(shift)
    np.testing.assert_array_equal(got, n // np.uint64(d))
    with pytest.raises(ValueError):
        norm.divider(0)


@pytest.mark.parametrize("shape", [(1, 273, 361), (8, 273, 361),
                                   (256, 273, 361), (1, 1, 1), (3, 5, 7),
                                   (2, 1, 100_000), (4, 500, 3),
                                   (2, 64, 1)], ids=str)
def test_plan_rows(shape):
    """Blocks of whole rows of one sample, at most MAX_ROWS of them (the
    kernel's shared tables), of at most 8192 elements unless one row is
    longer; enough blocks for the card at B = 1 of the paper shape; at B =
    256, 13 blocks of 21 rows a sample."""
    B, C, T = shape
    rows = norm.plan_rows(B, C, T)
    assert 1 <= rows <= min(C, norm.MAX_ROWS)
    assert rows * T <= 8192 or rows == 1
    blocks = B * -(-C // rows)
    if (B, C, T) == (1, 273, 361):
        assert blocks >= 91
    if (B, C, T) == (256, 273, 361):
        assert (rows, blocks) == (21, 256 * 13)


def test_signature_declared_and_defined():
    """ops/_build declares bm_normalize_clamp_peak's C signature, and
    csrc/normalize.cu defines it with as many parameters."""
    argtypes, restype = _build.SIGNATURES["bm_normalize_clamp_peak"]
    source = (CSRC / "normalize.cu").read_text()
    found = re.search(r'extern "C" int bm_normalize_clamp_peak\(([^)]*)\)',
                      source)
    assert found and restype is _build.ctypes.c_int
    assert len(found.group(1).split(",")) == len(argtypes) == 17
    assert "normalize.cu" in [p.name for p in _build._sources()]
