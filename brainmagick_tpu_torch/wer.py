"""Word-retrieval error ("WER") of a CLIP model on test batches.

Port of ``brainmagick_tpu/wer.py`` on one device, over batches each with
the ``dataset.ARRAY_FIELDS`` arrays, ``word_hash`` [B, T] (the word's hash
over its samples, 0 elsewhere) and optionally ``pad_weight`` [B]: those
of ``test_batches`` in the test stage of ``Solver.train``, or any the
caller builds. Every estimate is ranked against up to
``test.wer_negatives`` outputs drawn with the config's seed, its own output
taking the last negative's place; the result is the top-``test.wer_topx``
error over samples and over the word vocabulary. The pool is scored by
``losses.pool_scores`` (``nt_matmul`` on a CUDA device; with
``test.pool_int8`` int8 pools, and the own column through
``losses.own_scores_int8``), inside ``precision.exact_fp32``. As a rank
of a data-parallel run, a solver's forwards split each batch over the
ranks (``Solver.forward_batch``) and so does the scoring; on one host
every rank gets every row, and so the one-card metrics. On several hosts,
as in the JAX package's processes, each host ranks its own rows against
negatives drawn from its own rows, and the metrics are averaged over the
hosts (``parallel.average_metrics_across_processes``).
"""

from __future__ import annotations

import logging
import types
import typing as tp

import numpy as np
import torch

from .eval import check_index, host_array, solver_batches
from .losses import commit_rows, own_scores_int8, pool_scores, use_int8_pool
from .parallel import average_metrics_across_processes
from .precision import exact_fp32

logger = logging.getLogger(__name__)

#: estimate rows scored per call
CHUNK = 2048


def _lookup_word_hash(word_hash: np.ndarray, check_at: int) -> np.ndarray:
    """Word hash at the event sample, falling back to +-1/+-2 neighbors."""
    wh = word_hash[:, check_at]
    for offset in (-1, 1, -2, 2):
        idx = check_at + offset
        if 0 <= idx < word_hash.shape[1]:
            wh = np.where(wh == 0, word_hash[:, idx], wh)
    assert (wh != 0).all(), "missing word hash at segment onset"
    return wh


def test_batches(solver: tp.Any) -> tp.Iterator[types.SimpleNamespace]:
    """The test split's batches for ``get_wer`` (``eval.solver_batches``
    without events): the first ``test.wer_recordings`` recordings (of
    ``test.wer_study`` when set), shuffled with the config's seed."""
    test_args = solver.args.test
    return solver_batches(solver, test_args.wer_recordings, shuffle=True,
                          test_study=test_args.wer_study,
                          with_events=False)


@torch.no_grad()
@exact_fp32()
def get_wer(server: tp.Any, batches: tp.Iterable[tp.Any],
            stats: tp.Optional[tp.Dict[str, int]] = None
            ) -> tp.Dict[str, float]:
    """{"wer", "wer_vocab", "wer_n_vocab"} over the batches' kept rows
    (a host's rows, then the mean over the hosts, on several hosts).
    `stats`, when given, gains the transfer counts of
    ``losses.streamed_scores`` (this rank's, under a group) and the
    own-output pass's commits."""
    args = server.args
    test_args = args.test
    clip = server.clip
    if clip is None:
        raise ValueError("WER requires a CLIP configuration "
                         "(optim.loss='clip')")
    check_at = check_index(args)
    device = server.device

    estimates_list, outputs_list, hashes_list = [], [], []
    local_rows = getattr(server, "local_rows", None)
    for batch in batches:
        word_hash = np.asarray(batch.word_hash)
        if local_rows is not None:
            # forward_batch returns this host's rows
            word_hash = word_hash[local_rows(len(word_hash))]
        estimate, output, _, keep_t = server.forward_batch(
            batch, getattr(batch, "pad_weight", None))
        keep = host_array(keep_t)
        if keep.any():
            estimates_list.append(host_array(estimate[keep_t]))
            outputs_list.append(host_array(output[keep_t]))
            hashes_list.append(_lookup_word_hash(word_hash[keep], check_at))
    estimates = np.concatenate(estimates_list)
    outputs = np.concatenate(outputs_list)
    word_hashes = np.concatenate(hashes_list).astype(np.int64)

    # seeded from the config, so that two runs report the same metrics
    rng = np.random.RandomState(args.seed % (2 ** 31))
    if test_args.wer_negatives:
        perm = rng.permutation(len(outputs))
        kept = perm[:test_args.wer_negatives]
        negatives, negative_hashes = outputs[kept], word_hashes[kept]
    else:
        negatives, negative_hashes = outputs, word_hashes
    logger.info("wer: %d negatives selected", len(negatives))

    if test_args.wer_random:
        estimates = rng.randn(*estimates.shape).astype(np.float32)

    # the estimate's own output replaces the last negative: the fixed pool
    # is negatives[:-1] and each row gets its own last column
    fixed_all = negatives[:-1]
    fixed_hashes = negative_hashes[:-1]
    n = len(estimates)
    scores = np.empty((n, len(fixed_all) + 1), dtype=np.float32)
    scores[:, :-1] = pool_scores(server, clip, estimates, fixed_all,
                                 chunk=CHUNK, stats=stats)
    for lo in range(0, n, CHUNK):
        est = commit_rows(estimates[lo:lo + CHUNK], device)
        own = commit_rows(outputs[lo:lo + CHUNK], device)
        # under test.pool_int8 both sides quantized, as the pool's columns
        own_scores = own_scores_int8 if use_int8_pool(args, clip) \
            else clip.own_scores
        scores[lo:lo + len(est), -1] = own_scores(est, own).cpu().numpy()
        if stats is not None:
            stats["commits"] = stats.get("commits", 0) + 2
            stats["commit_bytes"] = (stats.get("commit_bytes", 0)
                                     + est.nbytes + own.nbytes)
        del est, own
    scores -= scores.max(axis=1, keepdims=True)
    np.exp(scores, out=scores)
    scores /= scores.sum(axis=1, keepdims=True)

    topx = test_args.wer_topx
    correct = 0.
    correct_vocab = 0.
    # the fixed pool's vocabulary grouping, shared by every row
    vocab_f, inv_f = np.unique(fixed_hashes, return_inverse=True)
    hashes_row = np.append(fixed_hashes, 0)  # the own column, set per row
    for p, wh in zip(scores, word_hashes):
        hashes_row[-1] = wh
        best = np.argpartition(p, -topx)[-topx:]
        correct += float((hashes_row[best] == wh).any())
        # vocab probabilities: fixed grouping + the own-output column
        p_vocab = np.bincount(inv_f, weights=p[:-1], minlength=len(vocab_f))
        j = np.searchsorted(vocab_f, wh)
        if j < len(vocab_f) and vocab_f[j] == wh:
            p_vocab[j] += p[-1]
            vocab = vocab_f
        else:
            vocab = np.append(vocab_f, wh)
            p_vocab = np.append(p_vocab, p[-1])
        k = min(topx, len(p_vocab))
        bests_vocab = np.argpartition(p_vocab, -k)[-k:]
        correct_vocab += float((vocab[bests_vocab] == wh).any())
    correct /= n
    correct_vocab /= n
    metrics = {"wer": 1 - correct, "wer_vocab": 1 - correct_vocab,
               # vocab top-k saturates when the pool has few unique words
               # (wer_vocab -> 0 for topx >= vocab size); reported so that
               # a 0.0 is distinguishable from a fault
               "wer_n_vocab": float(len(vocab_f))}
    return average_metrics_across_processes(
        metrics, getattr(server, "group", None))
