"""The PyTorch port's kernel modules (their plain CPU path) against the JAX
package: normalize_clamp_peak, nt_matmul, inv_norms and the retrieval
scorer built on them. Inputs come from numpy seeds and go through both
frameworks."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainmagick_tpu import losses as jlosses
from brainmagick_tpu.ops import pallas_matmul, pallas_norm
from brainmagick_tpu_torch import losses
from brainmagick_tpu_torch.ops import matmul, norm

# the module; ``ops.inv_norms`` is its wrapper
inv_norms = importlib.import_module("brainmagick_tpu_torch.ops.inv_norms")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("B,C,T", [(4, 16, 48), (3, 273, 361)])
def test_normalize_clamp_peak_matches_jax(B, C, T, clip):
    rng = np.random.RandomState(0)
    meg = rng.randn(B, C, T).astype(np.float32) * 4
    center = rng.randn(B, C).astype(np.float32)
    scale = (0.5 + rng.rand(B, C)).astype(np.float32)
    out, peak = norm.normalize_clamp_peak(
        torch.from_numpy(meg), torch.from_numpy(center),
        torch.from_numpy(scale), 2.5, clip=clip)
    args = (jnp.asarray(meg), jnp.asarray(center), jnp.asarray(scale), 2.5)
    want = [pallas_norm._reference_impl(*args, clip=clip)]
    if clip:  # the Pallas kernel only runs with the clamp
        want.append(pallas_norm.normalize_clamp_peak(*args, clip=True,
                                                     interpret=True))
    for out_j, peak_j in want:
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-6)
        np.testing.assert_allclose(peak.numpy(), np.asarray(peak_j),
                                   atol=1e-6)
    assert peak.numpy().max() > 2.5
    if clip:
        assert np.abs(out.numpy()).max() <= 2.5


def test_normalize_clamp_peak_rejects_bad_inputs():
    meg = torch.zeros(2, 3, 4)
    center = torch.zeros(2, 3)
    with pytest.raises(TypeError):
        norm.normalize_clamp_peak(meg.double(), center.double(),
                                  center.double(), 1.0)
    with pytest.raises(ValueError):
        norm.normalize_clamp_peak(meg, center[:1], center, 1.0)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no plain path
        norm.normalize_clamp_peak(meg.to("meta"), center.to("meta"),
                                  center.to("meta"), 1.0)
    # rec [B] int64 into [R, C] tables
    tables, rec = torch.zeros(5, 3), torch.tensor([0, 4])
    cases = [((meg, tables, tables, 1.0), ValueError, r"\[R, C\] with rec"),
             ((meg, tables, tables[:, :2], 1.0, True, rec), ValueError,
              "center/scale"),
             ((meg, tables, tables, 1.0, True, rec[:1]), ValueError, "rec"),
             ((meg, tables, tables, 1.0, True, rec.int()), TypeError,
              "int64"),
             ((meg.half(), tables, tables, 1.0, True, rec), TypeError,
              "fp32 or bf16"),
             ((meg, tables[:0], tables[:0], 1.0, True, rec), ValueError,
              "empty tables")]
    for args, error, match in cases:
        with pytest.raises(error, match=match):
            norm.normalize_clamp_peak(*args)
    out, peak = norm.normalize_clamp_peak(meg, tables, tables + 1, 1.0,
                                          rec=rec)
    assert out.shape == meg.shape and peak.shape == (2,)
    assert norm.normalize_clamp_peak.launches == 0  # CPU path never counts


def _matmul_operands(M, K, N, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32),
            rng.randn(N, K).astype(np.float32))


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16")])
def test_nt_matmul_matches_jax(dtypes):
    """Tolerances of tests/test_pallas.py: fp32 rtol/atol 1e-4 against the
    fp64 product; bf16 operands within bf16 rounding of it. Against the
    JAX kernel on the same operands, both accumulate in fp32."""
    a, b = _matmul_operands(16, 128 * 6, 256)
    da, db = dtypes
    got = matmul.nt_matmul(torch.from_numpy(a).to(getattr(torch, da)),
                           torch.from_numpy(b).to(getattr(torch, db)))
    assert got.dtype == torch.float32
    want = pallas_matmul.nt_matmul(jnp.asarray(a).astype(da),
                                   jnp.asarray(b).astype(db), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    ref = a.astype(np.float64) @ b.astype(np.float64).T
    tol = (dict(rtol=1e-4, atol=1e-4) if dtypes == ("float32", "float32")
           else dict(rtol=5e-2, atol=0.5))
    np.testing.assert_allclose(got.numpy(), ref, **tol)


def test_nt_matmul_untiled_shape():
    """Shapes with no 128-aligned tiling (the JAX function's XLA-dot
    fallback): the port has one path for every shape."""
    a, b = _matmul_operands(8, 100, 64, seed=1)
    got = matmul.nt_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(pallas_matmul.nt_matmul(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        matmul.nt_matmul(torch.zeros(2, 3), torch.zeros(4, 5))


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("K", [0, 7, 351_232])
@pytest.mark.parametrize("N", [1, 2048])
@pytest.mark.parametrize("M", [1, 7, 8, 9, 65, 256, 257, 1000, 2048])
def test_plan_tiles_covers_m_and_k(M, N, K, elem_bytes):
    """The CUDA kernel's tile plan: the smallest prediction width that
    covers M (a grid of the widest tiles above that: 128 in fp32, 256 in
    bf16), whole K steps with every k covered once, a bf16 split of at
    most MAX_BF16_STEPS K steps, and at the scoring shape at least one CTA
    per SM of the card's 132."""
    width, bank_rows, splits, k_chunk = matmul.plan_tiles(M, N, K, 132,
                                                          elem_bytes)
    widths = matmul.WIDTHS[elem_bytes]
    assert width in widths and bank_rows == matmul.BANK_ROWS
    if M <= widths[-1]:
        assert width >= M and all(w < M for w in widths if w < width)
    else:
        assert width == widths[-1]
    m_tiles = -(-M // width)
    assert (m_tiles - 1) * width < M <= m_tiles * width
    bk = matmul.STEP_BYTES // elem_bytes
    assert k_chunk % bk == 0 and splits >= 1
    assert splits * k_chunk >= K and (splits - 1) * k_chunk < max(K, 1)
    if elem_bytes == 2:
        assert k_chunk // bk <= matmul.MAX_BF16_STEPS
    ctas = -(-N // bank_rows) * m_tiles * splits
    if K == 351_232 and N == 2048 and M in (1, 256):
        assert ctas >= 132


def _round_tf32(x: np.ndarray, truncate: bool = False) -> np.ndarray:
    """cvt.rna.tf32.f32 on float32 values by integer ops: keep 10 mantissa
    bits, rounding half away from zero (or truncating)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    if not truncate:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32x3(a: np.ndarray, b: np.ndarray, truncate: bool = False
            ) -> np.ndarray:
    """The card's fp32 nt_matmul arithmetic: each operand split as
    hi = tf32(x), lo = tf32(x - hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi
    (the products of tf32 values are exact; summed here in fp64)."""
    def split(x):
        hi = _round_tf32(x, truncate)
        lo = _round_tf32(x - hi, truncate)
        return hi.astype(np.float64), lo.astype(np.float64)

    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def _tf32x3_case(name):
    rng = np.random.RandomState(7)
    k = 351_232 if name.startswith("K351232") else 4096
    rows = (2, 3) if k > 4096 else (4, 6)
    a, b = (rng.randn(r, k) for r in rows)
    if "one_sign" in name:
        a, b = np.abs(a), np.abs(b)
    if "range" in name:  # magnitudes spread over 2^-8 .. 2^8
        a, b = (x * 2.0 ** rng.uniform(-8, 8, x.shape) for x in (a, b))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("name", ["normal", "one_sign", "range_2_16",
                                  "K351232", "K351232_one_sign"])
def test_tf32x3_split_is_fp32_accurate(name):
    """3xTF32 with round-to-nearest splits stays within MATMUL_TOL = 1e-6
    of |a_m||b_n| of the exact product and of the JAX function (its
    fp32 XLA dot on the CPU). Max error over |a||b| measured here, rna
    split / truncating split: normal 2.1e-9 / 9.7e-9, one sign 3.1e-9 /
    1.8e-7, 2^16 range 3.2e-9 / 1.4e-8, K = 351,232 1.6e-10 / 9.5e-10,
    K = 351,232 one sign 2.4e-10 / 1.8e-7: truncation's errors share a
    sign, so they add up on one-sign data. At K = 351,232 on one-sign
    data the JAX function's own fp32 accumulation is ~3e-5 off the exact
    product, so that case is held to the exact product only."""
    a, b = _tf32x3_case(name)
    scale = (np.linalg.norm(a.astype(np.float64), axis=1)[:, None]
             * np.linalg.norm(b.astype(np.float64), axis=1)[None, :])
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    model = _tf32x3(a, b)
    assert (np.abs(model - exact) / scale).max() <= 1e-6
    if name != "K351232_one_sign":
        want = np.asarray(pallas_matmul.nt_matmul(jnp.asarray(a),
                                                  jnp.asarray(b)))
        assert (np.abs(model - want) / scale).max() <= 1e-6
    if "one_sign" in name:
        truncated = _tf32x3(a, b, truncate=True)
        assert (np.abs(model - exact).max()
                < np.abs(truncated - exact).max())


@pytest.mark.parametrize("dtype,K", [(torch.float32, 1), (torch.float32, 7),
                                     (torch.float32, 4099),
                                     (torch.bfloat16, 7),
                                     (torch.bfloat16, 1001)])
def test_tma_operand_zero_pads_unaligned_k(dtype, K):
    """The wrapper's zero-padding of K to 16-byte rows (K % 4 for fp32,
    K % 8 for bf16): the padded operands give the same plain product."""
    a, b = (torch.from_numpy(x).to(dtype) for x in _matmul_operands(5, K, 3))
    pa, pb = matmul.tma_operand(a), matmul.tma_operand(b)
    multiple = 16 // a.element_size()
    for x, px in ((a, pa), (b, pb)):
        assert px.shape == (x.shape[0], K + (-K % multiple))
        assert px.shape[1] % multiple == 0 and px.data_ptr() % 16 == 0
        assert torch.equal(px[:, :K], x) and not px[:, K:].any()
    torch.testing.assert_close(matmul._reference_impl(pa, pb),
                               matmul._reference_impl(a, b), rtol=1e-6,
                               atol=1e-5)


def test_tma_operand_keeps_or_copies_aligned_k():
    x = torch.zeros(5, 8)
    assert matmul.tma_operand(x) is x
    shifted = torch.arange(41, dtype=torch.float32)[1:].view(5, 8)
    assert shifted.data_ptr() % 16 != 0
    copied = matmul.tma_operand(shifted)
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, shifted)


def _clip_pair(kw):
    base = dict(dset_tmin=-0.5, dset_sample_rate=120.)
    return jlosses.ClipLoss(**base, **kw), losses.ClipLoss(**base, **kw)


@pytest.mark.parametrize("kw", [dict(), dict(compute_dtype="bfloat16"),
                                dict(tmin=-0.45, tmax=-0.4), dict(pool=True),
                                dict(center=True)], ids=str)
def test_retrieval_scores_matches_jax(kw):
    """Port retrieval_scores (nt_matmul fast path, or get_scores for a
    trim/transform config) against JAX retrieval_scores and get_scores."""
    rng = np.random.RandomState(0)
    est = rng.randn(6, 8, 16).astype(np.float32)
    cand = rng.randn(10, 8, 16).astype(np.float32)
    jclip, clip = _clip_pair(kw)
    params = jclip.init(jax.random.PRNGKey(0), jnp.asarray(est),
                        jnp.asarray(cand), method=jclip.get_scores)
    want_fast = jlosses.retrieval_scores(jclip, params, jnp.asarray(est),
                                         jnp.asarray(cand))
    want = jclip.apply(params, jnp.asarray(est), jnp.asarray(cand),
                       method=jclip.get_scores)
    got = losses.retrieval_scores(clip, torch.from_numpy(est),
                                  torch.from_numpy(cand))
    got_scores = clip.get_scores(torch.from_numpy(est),
                                 torch.from_numpy(cand))
    for g in (got, got_scores):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_fast),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    probs = clip.get_probabilities(torch.from_numpy(est),
                                   torch.from_numpy(cand))
    want_probs = jclip.apply(params, jnp.asarray(est), jnp.asarray(cand),
                             method=jclip.get_probabilities)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs),
                               atol=1e-5)


def test_retrieval_scores_with_precomputed_norms():
    rng = np.random.RandomState(2)
    est = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32))
    cand = torch.from_numpy(rng.randn(7, 4, 5).astype(np.float32))
    clip = losses.ClipLoss()
    inv = losses.block_inv_norms(cand)
    torch.testing.assert_close(
        losses.retrieval_scores(clip, est, cand, inv_norms=inv),
        losses.retrieval_scores(clip, est, cand))
    with pytest.raises(ValueError):
        losses.retrieval_scores(losses.ClipLoss(pool=True), est, cand,
                                inv_norms=inv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_inv_norms_matches_jax(dtype):
    block = np.random.RandomState(3).randn(9, 6, 11).astype(np.float32)
    got = losses.block_inv_norms(torch.from_numpy(block)
                                 .to(getattr(torch, dtype)))
    want = jlosses.block_inv_norms(jnp.asarray(block).astype(dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("shape,zero_row", [
    ((9, 6, 11), False), ((4, 13), True), ((1, 37), False),
    ((3, 2053), False)], ids=["block", "zero_row", "one_row", "small_n"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_inv_norms_plain_matches_block_inv_norms_and_jax(dtype, shape,
                                                         zero_row):
    """The one-pass kernel's plain version (its CPU path) gives
    block_inv_norms' values and the JAX package's, over fp32, bf16 and int8
    blocks, an all-zero row (1e8), K not a multiple of 8 and one row."""
    rng = np.random.RandomState(4)
    block = (rng.randint(-127, 128, shape).astype(np.int8) if dtype == "int8"
             else rng.randn(*shape).astype(np.float32))
    if zero_row:
        block[1] = 0
    t = torch.from_numpy(block)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    got = inv_norms.inv_norms(t)
    assert got.shape == (shape[0],) and got.dtype == torch.float32
    torch.testing.assert_close(got, losses.block_inv_norms(t), rtol=0,
                               atol=0)
    want = jlosses.block_inv_norms(jnp.asarray(block).astype(dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if zero_row:
        assert got[1].item() == pytest.approx(1e8)


@pytest.mark.parametrize("n,k,elem_bytes", [
    (2048, 351_232, 2), (2048, 351_232, 4), (200, 41_160, 4),
    (15, 41_160, 2), (1, 351_232, 1), (3, 7, 4), (1000, 0, 2)])
def test_inv_norms_plan_fills_the_card(n, k, elem_bytes):
    """One block a row once the rows fill 132 SMs; fewer rows split, each
    block keeping at least MIN_SPLIT_BYTES of its row."""
    splits = inv_norms.plan_splits(n, k, elem_bytes, 132)
    assert splits >= 1
    if n >= 132 * inv_norms.RESIDENT_BLOCKS:
        assert splits == 1
    if splits > 1:
        assert k * elem_bytes // splits >= inv_norms.MIN_SPLIT_BYTES
        assert n * (splits - 1) < 132 * inv_norms.RESIDENT_BLOCKS


def test_inv_norms_rejects_bad_inputs():
    with pytest.raises(TypeError):
        inv_norms.inv_norms(torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError):  # neither cpu nor cuda: no plain path
        inv_norms.inv_norms(torch.zeros(2, 3, device="meta"))
