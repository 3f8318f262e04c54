"""The PyTorch port's kernel modules (their plain CPU path) against the JAX
package: normalize_clamp_peak, nt_matmul and the retrieval scorer built on
it. Inputs come from numpy seeds and go through both frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainmagick_tpu import losses as jlosses
from brainmagick_tpu.ops import pallas_matmul, pallas_norm
from brainmagick_tpu_torch import losses
from brainmagick_tpu_torch.ops import matmul, norm


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


@pytest.mark.parametrize("M,N,K", [(256, 2048, 351_232), (1, 2048, 351_232),
                                   (3, 5, 7), (64, 64, 32), (1, 1, 0)])
def test_split_k_covers_k(M, N, K):
    """The CUDA kernel's K split: whole K steps, every k covered once, and
    at least the target blocks per SM where K allows it."""
    splits, k_chunk = matmul.split_k(M, N, K, n_sms=132)
    assert k_chunk % matmul._BK == 0 and splits >= 1
    assert splits * k_chunk >= K and (splits - 1) * k_chunk < max(K, 1)
    tiles = -(-M // 64) * -(-N // 64)
    if K >= matmul._BK * 4 * 132:
        assert tiles * splits >= 4 * 132


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
