"""The PyTorch port's offline evaluation (brainmagick_tpu_torch.eval, .wer
and the streaming pieces of .losses) against the JAX package's, on the
same batches and bridged weights, on the CPU: load_test_data, build_probs
(fp32, bf16 compute dtype, trim windows and the transform paths, two
candidate blocks with a ragged tail and ragged prediction chunks),
accuracy_from_probs, run_eval's files, get_wer, the device-group plan
and its prefetch order, EstimateCache and int8 pools; and the
same evaluation with the clip_conv_tpu recipe's server (bf16 compute and
estimates, bf16 scores and wire) against the JAX package's recipe."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args

from brainmagick_tpu import eval as bm_eval
from brainmagick_tpu import losses as bm_losses
from brainmagick_tpu import train as bm_train
from brainmagick_tpu import wer as bm_wer
from brainmagick_tpu.dataset import ConcatDataset
from brainmagick_tpu.env import env
from brainmagick_tpu_torch import eval as port_eval
from brainmagick_tpu_torch import losses, wer
from brainmagick_tpu_torch.dataset import to_device
from brainmagick_tpu_torch.precision import torch_dtype
from brainmagick_tpu_torch.serve import Server

#: preds and trues from the two forwards (the serving test's tolerance)
FORWARD_TOL = 1e-4
#: probabilities, fp32 scoring: both sides accumulate in fp32 (the largest
#: difference measured over the build_probs cases below, three seeds: 2e-8)
PROBS_TOL = 1e-5
#: probabilities, bf16 operands: both sides round the operands to bf16
#: alike and accumulate the exact products in fp32 in other orders
#: (measured: 6.5e-9)
PROBS_TOL_BF16 = 1e-6
#: bf16 operands centered first: the fp32 means differ in their last bit,
#: and some operands then round to the neighbouring bf16 value (measured:
#: 1.4e-5)
PROBS_TOL_BF16_CENTERED = 1e-4
#: the clip_conv_tpu recipe's options on tiny_args (bf16 compute and
#: estimates, no conv bias before BatchNorm, the fused head, tanh GELU,
#: bf16 scores and the bf16 wire)
RECIPE = ["simpleconv.dtype=bfloat16", "simpleconv.output_dtype=bfloat16",
          "simpleconv.bn_conv_bias=False", "simpleconv.fused_head=True",
          "simpleconv.gelu_exact=False", "clip.compute_dtype=bfloat16",
          "parallel.transfer_dtype=bfloat16"]
#: the recipe's estimates, a whole bf16 forward in each framework: the
#: error's norm over the estimates' norm, as tests/test_torch_recipe.py's
#: RECIPE_TOL (measured: 1.1e-2)
RECIPE_PREDS_TOL = 2 ** -5
#: the recipe's probabilities: each framework's bf16 estimates, scored in
#: bf16 against the same candidates (measured: 3.9e-5); the top-k
#: accuracies then differ by at most the rows whose target sits this close
#: to the boundary
RECIPE_PROBS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _on_the_wire(batch, test_features):
    """`batch` with meg and the model's feature channels rounded to bf16
    (the WordHash channel kept), as the port's bf16 wire gives them to
    its model: the JAX solver's forward crosses in fp32."""
    features = np.array(batch.features)
    keep = test_features.get_slice("WordHash")
    hashes = features[:, keep].copy()
    features = torch.from_numpy(features).bfloat16().float().numpy()
    features[:, keep] = hashes
    return dataclasses.replace(
        batch, features=features,
        meg=torch.from_numpy(np.asarray(batch.meg)).bfloat16().float()
        .numpy())


def _replaying_solver(tmp, overrides=()):
    """The tiny_args JAX solver (with `overrides`) with seeded BatchNorm
    running statistics, whose make_loader replays one recorded list of
    test batches (with their events), so that both packages see the same
    batches in the same order; with ``parallel.transfer_dtype``, the
    batches as the port's wire gives them (``_on_the_wire``)."""
    cache = tmp / "fake_cache"
    cache.mkdir()
    args = bm_train.parse_overrides(list(overrides), tiny_args(cache, tmp))
    with env.temporary(cache=cache):
        solver = bm_train.get_solver(args, training=False)
        rng = np.random.RandomState(0)

        def draw(path, leaf):
            if path[-1].key == "mean":
                return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        stats = jax.tree_util.tree_map_with_path(
            draw, jax.device_get(solver.state["batch_stats"]))
        solver.state = {**solver.state,
                        "batch_stats": jax.device_put(stats)}
        recorded = list(solver.make_loader(
            ConcatDataset(solver.datasets.test.datasets), with_events=True))
        if args.parallel.transfer_dtype:
            test_features = solver.datasets.test.datasets[0].features
            recorded = [(_on_the_wire(batch, test_features), pad)
                        for batch, pad in recorded]
        solver.make_loader = lambda *args, **kwargs: recorded
    return solver


def _server(solver):
    return Server(solver.args, solver.model.in_channels["meg"],
                  solver.model.out_channels, solver.model.n_subjects,
                  jax.device_get(solver.state["params"]),
                  jax.device_get(solver.state["batch_stats"]),
                  {k: np.asarray(v) for k, v in solver.norm_arrays.items()},
                  device="cpu")


def _batches(solver):
    """The replayed batches as the port takes them: the model's features
    extracted, the WordHash channel as word_hash, the events, the study
    name and the loader's pad weights."""
    test_features = solver.datasets.test.datasets[0].features
    used = list(solver.used_features.keys())
    out = []
    for batch, pad_weight in solver.make_loader(None):
        fields = {name: getattr(batch, name)
                  for name in batch.ARRAY_FIELDS}
        fields["features"] = test_features.extract_features(batch.features,
                                                            used)
        out.append(types.SimpleNamespace(
            **fields, event_lists=batch._event_lists,
            study="-".join(sorted({r.study_name()
                                   for r in batch._recordings})),
            word_hash=batch.features[:, test_features.get_slice(
                "WordHash")][:, 0],
            pad_weight=pad_weight))
    assert any(b.pad_weight.min() == 0 for b in out)
    return out


@pytest.fixture(scope="module")
def solver(tmp_path_factory):
    return _replaying_solver(tmp_path_factory.mktemp("eval"))


@pytest.fixture(scope="module")
def server(solver):
    return _server(solver)


@pytest.fixture(scope="module")
def batches(solver):
    return _batches(solver)


@pytest.fixture(scope="module")
def test_data(solver, server, batches):
    return bm_eval.load_test_data(solver), port_eval.load_test_data(
        server, batches)


def test_load_test_data_matches_jax(test_data):
    want, got = test_data
    assert set(got) == set(want)
    for key, value in want.items():
        if key in ("preds", "trues"):
            assert got[key].shape == value.shape, key
            np.testing.assert_allclose(got[key], value, rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL, err_msg=key)
        else:
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    # one candidate per segment, fewer than the predictions
    assert len(np.unique(got["trues_segment_hashes"])) == len(got["trues"])
    assert len(got["trues"]) < len(got["preds"])


def test_load_test_data_hashes_words_without_word_hash(server, batches,
                                                       test_data):
    """Batches without word_hash: each prediction's word hash is the JAX
    package's stable_word_hash of its word at the event's sample, and the
    rest of the data is as with the WordHash channel."""
    from brainmagick_tpu.features.basic import stable_word_hash

    bare = [types.SimpleNamespace(**{k: v for k, v in vars(b).items()
                                     if k != "word_hash"}) for b in batches]
    got = port_eval.load_test_data(server, bare)
    want = test_data[1]
    np.testing.assert_array_equal(
        got["word_hashes"], [stable_word_hash(w) for w in got["word_strings"]])
    for key in ("segment_hashes", "trues_segment_hashes", "word_strings"):
        np.testing.assert_array_equal(got[key], want[key])


def _clips(**kw):
    """The same ClipLoss in both packages, and the port's."""
    clip_j = bm_losses.ClipLoss(dset_tmin=-0.2, dset_sample_rate=120., **kw)
    return clip_j, losses.ClipLoss(dset_tmin=-0.2, dset_sample_rate=120.,
                                   **kw)


#: build_probs cases: the ClipLoss's options, build_probs' trim window, the
#: tolerance
PROBS_CASES = {
    "fp32": ({}, {}, PROBS_TOL),
    "bf16": (dict(compute_dtype="bfloat16"), {}, PROBS_TOL_BF16),
    "trim": ({}, dict(tmin=-0.1, tmax=0.1), PROBS_TOL),
    "bf16 trim": (dict(compute_dtype="bfloat16"), dict(tmin=0.0),
                  PROBS_TOL_BF16),
    "clip window": (dict(tmin=-0.1, tmax=0.1), {}, PROBS_TOL),
    "pool": (dict(pool=True), {}, PROBS_TOL),
    "center bf16": (dict(center=True, compute_dtype="bfloat16"), {},
                    PROBS_TOL_BF16_CENTERED),
}


@pytest.mark.parametrize("case", PROBS_CASES)
def test_build_probs_matches_jax(solver, case):
    """5 predictions against 2,100 candidates at F x T = 4 x 40: two
    candidate blocks of 2048, the JAX tail block zero-padded, and
    prediction chunks of 3 and 2."""
    clip_kw, window, tol = PROBS_CASES[case]
    rng = np.random.RandomState(1)
    preds = rng.randn(5, 4, 40).astype(np.float32)
    trues = rng.randn(2100, 4, 40).astype(np.float32)
    clip_j, clip_p = _clips(**clip_kw)
    want = bm_eval.build_probs(
        types.SimpleNamespace(args=solver.args, clip_loss=clip_j,
                              state={"params": {}}),
        preds, trues, batch_size=3, **window)
    stats = {}
    got = port_eval.build_probs(
        types.SimpleNamespace(args=solver.args, clip=clip_p,
                              device=torch.device("cpu")),
        preds, trues, batch_size=3, stats=stats, **window)
    assert got.shape == want.shape == (5, 2100)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    # both blocks in one group; each chunk committed once
    assert stats["groups"] == 1 and stats["commits"] == 2


def test_accuracy_and_run_eval_files_match_jax(solver, server, batches,
                                               test_data, tmp_path):
    """accuracy_from_probs at top-1/5/10 on each package's probabilities,
    then run_eval: the same probabilities and vocabulary, and metadata.csv,
    acc.csv and negative_stats.csv byte for byte."""
    (want, got) = test_data
    probs_j = bm_eval.build_probs(solver, want["preds"], want["trues"],
                                  batch_size=16)
    probs_p = port_eval.build_probs(server, got["preds"], got["trues"],
                                    batch_size=16)
    np.testing.assert_allclose(probs_p, probs_j, rtol=0, atol=PROBS_TOL)
    for k in (1, 5, 10):
        assert port_eval.accuracy_from_probs(
            probs_p, got["segment_hashes"], got["trues_segment_hashes"],
            topk=k) == bm_eval.accuracy_from_probs(
            probs_j, want["segment_hashes"], want["trues_segment_hashes"],
            topk=k)

    df = bm_eval.run_eval(solver, tmp_path / "jax", n_negatives=30,
                          probs_batch_size=16)
    acc = port_eval.run_eval(server, batches, tmp_path / "port",
                             n_negatives=30, probs_batch_size=16)
    assert acc == df.acc_segment.to_dict()
    for name in ("metadata.csv", "acc.csv", "negative_stats.csv"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "vocab_segment.npy"),
        np.load(tmp_path / "jax" / "vocab_segment.npy"))
    np.testing.assert_allclose(
        np.load(tmp_path / "port" / "probs_segment.npy"),
        np.load(tmp_path / "jax" / "probs_segment.npy"), rtol=0,
        atol=PROBS_TOL)


def _with_test(solver, **changes):
    """The solver's args with test fields changed (the JAX solver's own
    args object is left as it is)."""
    return dataclasses.replace(
        solver.args, test=dataclasses.replace(solver.args.test, **changes))


@pytest.mark.parametrize("changes", [{}, dict(wer_negatives=0),
                                     dict(wer_topx=1),
                                     dict(wer_random=True)], ids=str)
def test_get_wer_matches_jax(solver, server, batches, changes, monkeypatch):
    args = _with_test(solver, **changes)
    monkeypatch.setattr(solver, "args", args)
    monkeypatch.setattr(server, "args", args)
    want = bm_wer.get_wer(solver)
    stats = {}
    got = wer.get_wer(server, batches, stats=stats)
    assert got == want
    assert 0 <= got["wer"] <= 1 and got["wer_n_vocab"] > 1
    # one chunk: the fixed pool's commit and the own-output pass's two
    assert stats["commits"] == 3 and stats["groups"] == 1


def test_get_wer_own_output_scores_match_jax(solver, server):
    """The own-output column: ClipLoss.own_scores against the diagonal of
    the JAX get_scores, also with a bf16 compute dtype and a window."""
    rng = np.random.RandomState(2)
    est = rng.randn(7, 4, 40).astype(np.float32)
    out = rng.randn(7, 4, 40).astype(np.float32)
    for kw in ({}, dict(compute_dtype="bfloat16"),
               dict(tmin=-0.1, center=True)):
        clip_j, clip_p = _clips(**kw)
        want = np.diag(np.asarray(clip_j.apply(
            {}, jnp.asarray(est), jnp.asarray(out),
            method=clip_j.get_scores)))
        got = clip_p.own_scores(torch.from_numpy(est), torch.from_numpy(out))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


class _Block:
    """A stand-in candidate block that logs its transfer."""

    def __init__(self, index, nbytes, log):
        self.index, self.nbytes, self.log = index, nbytes, log

    def to(self, device, non_blocking=False):
        self.log.append(("put", self.index))
        return self


@pytest.mark.parametrize("n_blocks,budget", [
    (5, 3), (5, 6), (5, 10), (7, 4), (2, 1), (1, 1), (6, 5), (4, 2)])
def test_iter_device_groups_matches_jax(n_blocks, budget, monkeypatch):
    """The groups (first index and blocks) and the order of transfers and
    yields, against the JAX function (its transfers seen through
    jax.device_put)."""
    def run(fn, **kw):
        log = []
        blocks = [_Block(i, 1, log) for i in range(n_blocks)]
        for first, group in fn(blocks, budget_bytes=budget, **kw):
            log.append(("yield", first, [b.index for b in group]))
        return log

    monkeypatch.setattr(jax, "device_put",
                        lambda block, sharding: block.to(None))
    want = run(bm_losses.iter_device_groups, sharding=object())
    got = run(losses.iter_device_groups, device="cpu")
    assert got == want
    assert [i for kind, *rest in got if kind == "yield"
            for i in rest[1]] == list(range(n_blocks))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_candidate_blocks_match_jax(compute_dtype):
    """The port's blocks are the JAX blocks without the tail's zero rows."""
    pool = np.random.RandomState(3).randn(5, 3, 4).astype(np.float32)
    want = bm_losses.candidate_blocks(pool, compute_dtype, block_size=2)
    got = losses.candidate_blocks(pool, torch_dtype(compute_dtype),
                                  block_size=2)
    assert [len(b) for b in got] == [2, 2, 1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32)[:len(g)])
    assert not want[-1][1:].any()
    assert got[0].dtype == (torch.bfloat16 if compute_dtype
                            else torch.float32)


def test_estimate_cache():
    """A prepared chunk scores as the in-call cast does, a hit returns the
    same tensor without calling its maker, and a chunk over the budget is
    prepared but not kept."""
    rng = np.random.RandomState(0)
    est = rng.randn(8, 4, 10).astype(np.float32)
    cand = rng.randn(6, 4, 10).astype(np.float32)
    _, clip = _clips(compute_dtype="bfloat16")
    block = torch.from_numpy(cand).to(torch.bfloat16)
    inv = losses.block_inv_norms(block)
    direct = losses.retrieval_scores(clip, torch.from_numpy(est), block, inv)
    cache = losses.EstimateCache(clip, torch.device("cpu"))
    prep = cache.get(0, lambda: est)
    assert prep.dtype == torch.bfloat16
    assert torch.equal(losses.retrieval_scores(clip, prep, block, inv),
                       direct)
    assert cache.get(0, lambda: 1 / 0) is prep
    assert (cache.commits, cache.committed_bytes) == (1, est.nbytes)

    tiny = losses.EstimateCache(clip, torch.device("cpu"), budget_bytes=1)
    assert tiny.get(0, lambda: est).dtype == torch.bfloat16
    assert 0 not in tiny._cache
    assert tiny.get(0, lambda: est) is not None and tiny.commits == 2
    # a transform configuration keeps the committed rows as they are
    _, pooled = _clips(pool=True, compute_dtype="bfloat16")
    assert losses.EstimateCache(pooled, torch.device("cpu")).get(
        0, lambda: est).dtype == torch.float32


def test_solver_forward_batch_crosses_in_fp32(solver, server, batches,
                                             monkeypatch):
    """With parallel.transfer_dtype="bfloat16", the solver's forward (the
    evaluation's by signature and the test stage's) still sends meg and
    features in fp32, as the JAX solver's forward_batch does (only its
    train and valid steps cross in bf16); the server's sends them in
    bf16."""
    args = dataclasses.replace(solver.args, parallel=dataclasses.replace(
        solver.args.parallel, transfer_dtype="bfloat16"))
    batch = batches[0]
    fp32 = server.solver.forward_batch(batch)
    monkeypatch.setattr(server, "args", args)
    monkeypatch.setattr(server.solver, "args", args)
    got = server.solver.forward_batch(batch)
    for a, b in zip(got, fp32):
        assert torch.equal(a, b)
    wire = server.forward_batch(batch)[1]
    with torch.no_grad():
        want = server.solver._forward(to_device(batch, "cpu", "bfloat16"),
                                      torch.ones(len(batch.meg)))[1]
    assert torch.equal(wire, want) and not torch.equal(wire, fp32[1])


def test_pool_int8_raises(solver, server, batches, tmp_path, monkeypatch):
    """test.pool_int8: build_probs, get_wer and run_eval score the
    server's int8 pool and run to the end, build_probs equal to the JAX
    package's int8 probabilities on the same operands within PROBS_TOL; a
    transform configuration scores in fp32, as the JAX package does. The
    name is kept from when the port refused the option, so that the test
    stays the same test across that change; it no longer checks a
    refusal."""
    args = _with_test(solver, pool_int8=True)
    monkeypatch.setattr(server, "args", args)
    rng = np.random.RandomState(5)
    preds = rng.randn(3, 4, 40).astype(np.float32)
    trues = rng.randn(4, 4, 40).astype(np.float32)
    probs = port_eval.build_probs(server, preds, trues)
    clip_j, _ = _clips()
    want = bm_eval.build_probs(
        types.SimpleNamespace(args=args, clip_loss=clip_j,
                              state={"params": {}}), preds, trues)
    np.testing.assert_allclose(probs, want, rtol=0, atol=PROBS_TOL)
    assert set(wer.get_wer(server, batches)) == {"wer", "wer_vocab",
                                                 "wer_n_vocab"}
    acc = port_eval.run_eval(server, batches, tmp_path, n_negatives=30,
                             probs_batch_size=16)
    assert all(0 <= value <= 1 for value in acc.values())
    _, pooled = _clips(pool=True)
    data = np.zeros((2, 4, 40), np.float32)
    probs = port_eval.build_probs(
        types.SimpleNamespace(args=args, clip=pooled,
                              device=torch.device("cpu")), data, data)
    assert probs.shape == (2, 2)
    fp32 = port_eval.build_probs(
        types.SimpleNamespace(args=solver.args, clip=pooled,
                              device=torch.device("cpu")), data, data)
    np.testing.assert_array_equal(probs, fp32)


# -- the clip_conv_tpu recipe ---------------------------------------------


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The recipe's JAX solver, the port's server on its weights, and the
    replayed batches."""
    solver = _replaying_solver(tmp_path_factory.mktemp("eval_recipe"),
                               RECIPE)
    server = _server(solver)
    batches = _batches(solver)
    assert server.forward_batch(batches[0])[0].dtype == torch.bfloat16
    return solver, server, batches


def _norm_err(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_recipe_load_test_data_matches_jax(recipe):
    """The recipe's bf16 estimates within RECIPE_PREDS_TOL in norm (they
    reach the host upcast to fp32), the outputs within FORWARD_TOL, the
    metadata exactly."""
    solver, server, batches = recipe
    want = bm_eval.load_test_data(solver)
    got = port_eval.load_test_data(server, batches)
    assert set(got) == set(want)
    err = _norm_err(got["preds"], np.asarray(want["preds"], np.float32))
    print(f"recipe preds: |port - jax| / |jax| = {err:.2e}")
    assert got["preds"].dtype == np.float32 and err <= RECIPE_PREDS_TOL
    np.testing.assert_allclose(got["trues"], want["trues"],
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)
    for key, value in want.items():
        if key not in ("preds", "trues"):
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_recipe_build_probs_matches_jax(recipe):
    """bf16 scoring of the same predictions and candidates (the JAX
    package's): both round the operands to bf16 alike, within
    PROBS_TOL_BF16."""
    solver, server, _ = recipe
    data = bm_eval.load_test_data(solver)
    preds = np.asarray(data["preds"], np.float32)
    want = bm_eval.build_probs(solver, preds, data["trues"], batch_size=16)
    got = port_eval.build_probs(server, preds, data["trues"],
                                batch_size=16)
    print(f"recipe probs, same operands: max |port - jax| = "
          f"{np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_TOL_BF16)


def test_recipe_run_eval_and_wer_match_jax(recipe, tmp_path):
    """run_eval with each package's own bf16 estimates: metadata.csv and
    negative_stats.csv byte for byte, the same vocabulary, the
    probabilities within RECIPE_PROBS_TOL, each top-k accuracy within the
    share of rows whose target sits within RECIPE_PROBS_TOL of the top-k
    boundary; get_wer's metrics equal to the JAX package's (its top-3
    among 50 candidates; measured equal on these batches)."""
    solver, server, batches = recipe
    df = bm_eval.run_eval(solver, tmp_path / "jax", n_negatives=30,
                          probs_batch_size=16)
    acc = port_eval.run_eval(server, batches, tmp_path / "port",
                             n_negatives=30, probs_batch_size=16)
    for name in ("metadata.csv", "negative_stats.csv"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    vocab = np.load(tmp_path / "jax" / "vocab_segment.npy")
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "vocab_segment.npy"), vocab)
    got = np.load(tmp_path / "port" / "probs_segment.npy")
    want = np.load(tmp_path / "jax" / "probs_segment.npy")
    print(f"recipe run_eval probs: max |port - jax| = "
          f"{np.abs(got - want).max():.2e} over {want.shape}")
    np.testing.assert_allclose(got, want, rtol=0, atol=RECIPE_PROBS_TOL)
    targets = bm_eval.load_test_data(solver)["segment_hashes"]
    kth_all = -np.sort(-want, axis=1)
    target = np.array([want[i][vocab == t].max()
                       for i, t in enumerate(targets)])
    for k, value in df.acc_segment.to_dict().items():
        near = np.abs(target - kth_all[:, min(k, want.shape[1]) - 1]) \
            <= RECIPE_PROBS_TOL
        print(f"recipe top-{k}: port {acc[k]}, jax {value}, "
              f"{near.sum()} of {len(near)} near the boundary")
        assert abs(acc[k] - value) <= near.sum() / len(near)

    want = bm_wer.get_wer(solver)
    got = wer.get_wer(server, batches)
    print(f"recipe get_wer: port {got}, jax {want}")
    assert got == want
