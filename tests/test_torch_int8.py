"""int8 candidate pools (``test.pool_int8``) in the port against the JAX
package's (tests/test_int8.py, one port test for each of its tests, and
the pieces between them): the host quantization of the candidate blocks
and the device quantization of the estimate rows bit for bit, the int32
partial sums over K chunks that cannot overflow, the scores, the own
column, the gating, the evaluation's probabilities and the WER.

Tolerances: int8 blocks, rows and partial sums bit-equal; scores on the
same inputs within 1e-6 of their largest magnitude (the same integer
products, fp32 sums of the partials in the same order; the row and norm
scales are fp32 products); the own column rtol 1e-5 (its fp32 sum runs in
another order); against fp32 scoring, tests/test_int8.py's bounds."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import _with_test, batches, server, solver  # noqa

from brainmagick_tpu import eval as bm_eval
from brainmagick_tpu import losses as bm_losses
from brainmagick_tpu.config import MainConfig as JaxMainConfig
from brainmagick_tpu_torch import eval as port_eval
from brainmagick_tpu_torch import losses, wer
from brainmagick_tpu_torch.config import MainConfig

#: scores of the same operands: max |port - JAX| over max |JAX|
SCORE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=SCORE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_candidate_blocks_int8_layout():
    """Two blocks of 4 (the port's tail block left short, the JAX one
    zero-padded): int8 rows bit-equal to the JAX package's, each using the
    full int8 range and dequantizing to the pool within half a step."""
    rng = np.random.RandomState(0)
    pool = rng.randn(5, 3, 7).astype(np.float32) * 3.0
    got = losses.candidate_blocks(pool, None, block_size=4, int8=True)
    want = bm_losses.candidate_blocks(pool, compute_dtype=None,
                                      block_size=4, int8=True)
    assert [tuple(b.shape) for b in got] == [(4, 3, 7), (1, 3, 7)]
    assert all(b.dtype == torch.int8 for b in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w[:len(g)])
    assert (want[1][1:] == 0).all()
    q = torch.cat(got).reshape(5, -1).numpy()
    assert (np.abs(q).max(axis=1) == 127).all()
    scale = np.abs(pool.reshape(5, -1)).max(axis=1) / 127
    np.testing.assert_allclose(q * scale[:, None], pool.reshape(5, -1),
                               atol=scale.max() / 2 + 1e-7)
    # the compute dtype does not change an int8 block
    again = losses.candidate_blocks(pool, torch.bfloat16, block_size=4,
                                    int8=True)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_quantize_rows_bit_equal_jax():
    """``_int8_quantize_rows``: the int8 rows and the fp32 scales of the
    JAX package bit for bit, ties rounding half to even (2.5 -> 2, 3.5 ->
    4, -0.5 -> 0), an all-zero row at the 1e-12 scale, and ``own`` rows
    quantized on the host the same way (``quantize_candidates``)."""
    rng = np.random.RandomState(1)
    x = rng.randn(9, 50).astype(np.float32) * 4
    x[0, :5] = [127., 2.5, 3.5, -0.5, -126.5]
    x[1] = 0.
    q, s = losses._int8_quantize_rows(_t(x))
    qj, sj = bm_losses._int8_quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert q[0, :5].tolist() == [127, 2, 4, 0, -126]
    assert (q[1] == 0).all() and s[1].item() == np.float32(1e-12)
    np.testing.assert_array_equal(losses.quantize_candidates(x[2:]),
                                  q[2:].numpy())


def test_int8_scores_close_to_fp32_and_rank_exact():
    """The int8 scores within 5% of the fp32 scores' spread, with
    self-retrieval exact, as the JAX test; and within SCORE_TOL of the
    JAX package's int8 scores on the same operands."""
    rng = np.random.RandomState(1)
    B, F, T = 16, 12, 23
    est = rng.randn(B, F, T).astype(np.float32)
    cands = np.concatenate(
        [est + 0.05 * rng.randn(B, F, T).astype(np.float32),
         rng.randn(2 * B, F, T).astype(np.float32)])
    clip = losses.ClipLoss(dset_tmin=-0.5, dset_sample_rate=10.)
    assert losses.int8_retrieval_ok(clip)
    ref = losses.retrieval_scores(clip, _t(est), _t(cands)).numpy()
    (blk,) = losses.candidate_blocks(cands, None, block_size=len(cands),
                                     int8=True)
    got = losses.retrieval_scores_int8(_t(est), blk).numpy()
    assert np.abs(got - ref).max() < 0.05 * ref.std()
    np.testing.assert_array_equal(got.argmax(axis=1), ref.argmax(axis=1))
    np.testing.assert_array_equal(got.argmax(axis=1), np.arange(B))
    want = bm_losses.retrieval_scores_int8(jnp.asarray(est),
                                           jnp.asarray(blk.numpy()))
    _close(got, want)
    # a prepared (e_q, s_e) pair and precomputed norms give the same bits
    pair = losses._int8_quantize_rows(_t(est).reshape(B, -1))
    again = losses.retrieval_scores_int8(pair, blk,
                                         losses.block_inv_norms(blk))
    assert torch.equal(again, _t(got))


def test_own_scores_int8_matches_full_matrix_diagonal():
    """The own column: the diagonal of the int8 score matrix against the
    rows' own quantized outputs, and the JAX package's own column."""
    rng = np.random.RandomState(2)
    est = rng.randn(6, 4, 9).astype(np.float32)
    own = rng.randn(6, 4, 9).astype(np.float32)
    q, _ = losses._int8_quantize_rows(_t(own).reshape(6, -1))
    full = losses.retrieval_scores_int8(_t(est), q).numpy()
    diag = losses.own_scores_int8(_t(est), _t(own)).numpy()
    np.testing.assert_allclose(diag, np.diagonal(full), rtol=1e-5,
                               atol=1e-6)
    want = np.asarray(bm_losses.own_scores_int8(jnp.asarray(est),
                                                jnp.asarray(own)))
    np.testing.assert_allclose(diag, want, rtol=1e-5, atol=1e-6)


def test_int8_k_chunking_no_overflow():
    """K = 300,000 > 133,144 = (2^31 - 1) // 127^2: a row of 127s against
    itself would overflow one int32 sum; the three chunks' partial sums
    are each exact (127^2 x the chunk's width) and the score is sqrt(K),
    as the JAX package's."""
    K = 300_000
    assert losses.INT8_K_CHUNK == 133_144
    ones = np.ones((1, 1, K), np.float32)
    q = (127 * ones).astype(np.int8)
    parts = losses.int8_partial_sums(_t(q).reshape(1, K),
                                     _t(q).reshape(1, K))
    widths = [133_144, 133_144, K - 2 * 133_144]
    assert [p.item() for p in parts] == [127 * 127 * w for w in widths]
    assert all(p.dtype == torch.int32 for p in parts)
    got = losses.retrieval_scores_int8(_t(ones), _t(q)).numpy()
    np.testing.assert_allclose(got[0, 0], np.sqrt(K), rtol=1e-4)
    want = bm_losses.retrieval_scores_int8(jnp.asarray(ones),
                                           jnp.asarray(q))
    _close(got, want)


def test_int8_partial_sums_are_exact():
    """Random int8 operands over several chunks (a ragged last one): each
    partial sum equals the int64 product of its chunk, from the tensors
    and from their ``int8_rows`` (chunks padded to INT8_K_ALIGN columns
    on 16-byte boundaries, rows to at least 32, the padding zero), and
    the scores against laid-out candidates need their norms."""
    rng = np.random.RandomState(3)
    k = 2 * losses.INT8_K_CHUNK + 13
    a = rng.randint(-127, 128, (3, k)).astype(np.int8)
    b = rng.randint(-127, 128, (5, k)).astype(np.int8)
    rows = losses.int8_rows(_t(b))
    assert rows.rows == 5 and rows.nbytes == 32 * (2 * 133_248 + 128)
    assert [c.shape for c in rows.chunks] == [
        (32, 133_248), (32, 133_248), (32, 128)]
    assert all(c.data_ptr() % 16 == 0 and c.stride(0) % 16 == 0
               for c in rows.chunks)
    np.testing.assert_array_equal(
        torch.cat([c[:5, :w] for c, w in zip(rows.chunks, (
            losses.INT8_K_CHUNK, losses.INT8_K_CHUNK, 13))], dim=1).numpy(),
        b)
    assert sum(int(c.count_nonzero()) for c in rows.chunks) \
        == int(np.count_nonzero(b))
    for parts in (losses.int8_partial_sums(_t(a), _t(b)),
                  losses.int8_partial_sums(losses.int8_rows(_t(a)), rows)):
        assert len(parts) == 3
        for j, part in enumerate(parts):
            sl = slice(j * losses.INT8_K_CHUNK,
                       (j + 1) * losses.INT8_K_CHUNK)
            want = a[:, sl].astype(np.int64) @ b[:, sl].astype(np.int64).T
            np.testing.assert_array_equal(part.numpy(), want)
    pair = losses._int8_quantize_rows(_t(a).float())
    with pytest.raises(ValueError, match="norms"):
        losses.retrieval_scores_int8(pair, rows)
    assert torch.equal(
        losses.retrieval_scores_int8(pair, rows,
                                     losses.block_inv_norms(_t(b))),
        losses.retrieval_scores_int8(pair, _t(b)))


def test_int8_retrieval_ok_gating():
    """The fast-path condition, and ``use_int8_pool``: test.pool_int8 on
    a fast-path ClipLoss only (a transform configuration scores as
    without it, in the JAX package too)."""
    ok = losses.ClipLoss(dset_tmin=-0.5, dset_sample_rate=10.)
    assert losses.int8_retrieval_ok(ok)
    for kw in (dict(pool=True), dict(tmin=0.0), dict(center=True)):
        clip = losses.ClipLoss(dset_tmin=-0.5, dset_sample_rate=10., **kw)
        assert not losses.int8_retrieval_ok(clip)
        assert not bm_losses.int8_retrieval_ok(bm_losses.ClipLoss(
            dset_tmin=-0.5, dset_sample_rate=10., **kw))
    args = MainConfig()
    assert not losses.use_int8_pool(args, ok)
    args.test.pool_int8 = True
    assert losses.use_int8_pool(args, ok)
    assert not losses.use_int8_pool(args, losses.ClipLoss(
        pool=True, dset_tmin=-0.5, dset_sample_rate=10.))


def test_estimate_cache_int8_prepares_pairs():
    """With use_int8 a chunk is committed once and prepared as the
    ``(int8_rows(e_q), s_e)`` pair of its flattened rows, counted in the
    budget by both parts' bytes."""
    clip = losses.ClipLoss(dset_tmin=-0.5, dset_sample_rate=10.)
    rows = np.random.RandomState(4).randn(5, 3, 8).astype(np.float32)
    cache = losses.EstimateCache(clip, torch.device("cpu"), use_int8=True)
    pair = cache.get(0, lambda: rows)
    assert cache.get(0, lambda: rows) is pair and cache.commits == 1
    q, s = losses._int8_quantize_rows(_t(rows).reshape(5, -1))
    assert pair[0].rows == 5 and torch.equal(pair[1], s)
    (chunk,) = pair[0].chunks
    assert torch.equal(chunk[:5, :24], q)
    assert pair[0].nbytes == 32 * losses.INT8_K_ALIGN
    small = losses.EstimateCache(clip, torch.device("cpu"), use_int8=True,
                                 budget_bytes=pair[0].nbytes + 5 * 4 - 1)
    small.get(0, lambda: rows)
    small.get(0, lambda: rows)
    assert small.commits == 2


def test_ring_scoring_declines_int8():
    """``maybe_ring_scores`` returns None for an int8 pool (the JAX
    package keeps the streamed path), before looking at the operands."""
    args = MainConfig()
    args.parallel.ring_scoring = True
    server = types.SimpleNamespace(
        args=args, group=types.SimpleNamespace(size=2),
        device=torch.device("cpu"))
    clip = losses.ClipLoss(dset_tmin=-0.5, dset_sample_rate=10.)
    assert losses.maybe_ring_scores(server, clip, np.zeros((2, 3, 4)),
                                    np.zeros((3, 3, 4)),
                                    use_int8=True) is None


def test_build_probs_int8_close_to_fp32():
    """build_probs with test.pool_int8 against fp32 scoring (atol 0.02,
    the same argmax), as the JAX test; and against the JAX package's
    int8 build_probs on the same operands (SCORE_TOL), over two candidate
    blocks with a ragged tail and ragged prediction chunks."""
    rng = np.random.RandomState(3)
    F, T = 6, 11
    preds = rng.randn(7, F, T).astype(np.float32)
    trues = rng.randn(2100, F, T).astype(np.float32)
    args = MainConfig()
    clip = losses.ClipLoss(dset_tmin=args.dset.tmin,
                           dset_sample_rate=args.dset.sample_rate)
    server = types.SimpleNamespace(args=args, clip=clip,
                                   device=torch.device("cpu"))
    ref = port_eval.build_probs(server, preds, trues, batch_size=3)
    args.test.pool_int8 = True
    stats = {}
    got = port_eval.build_probs(server, preds, trues, batch_size=3,
                                stats=stats)
    np.testing.assert_allclose(got, ref, atol=0.02)
    np.testing.assert_array_equal(got.argmax(axis=1), ref.argmax(axis=1))
    # the pool crossed as int8: a quarter of its fp32 bytes
    assert stats["pool_bytes"] == trues.size
    jargs = JaxMainConfig()
    jargs.test.pool_int8 = True
    want = bm_eval.build_probs(types.SimpleNamespace(
        args=jargs, clip_loss=bm_losses.ClipLoss(
            dset_tmin=args.dset.tmin, dset_sample_rate=args.dset.sample_rate),
        state={"params": {}}), preds, trues, batch_size=3)
    _close(got, want)


def test_get_wer_int8_matches_fp32(server, batches, monkeypatch):
    """End-to-end WER on the fake study's test batches: the int8 pool
    (and the int8 own column) reproduces the fp32 metrics within
    quantization noise (0.05, as the JAX test)."""
    ref = wer.get_wer(server, batches)
    args = _with_test(server, pool_int8=True)
    monkeypatch.setattr(server, "args", args)
    got = wer.get_wer(server, batches)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key] == pytest.approx(ref[key], abs=0.05), key
