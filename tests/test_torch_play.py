"""The port's notebook helpers (brainmagick_tpu_torch.play) against the JAX
package's on the same inputs and bridged weights: ``SentenceFeatures``
(events, painted features, ``generate``), ``extract_basal_states``'
windows, ``attention_map`` with shared and per-subject merger heads,
``Solver.predict`` (the fused head with the batch's own subject) and
``play.predict`` with and without ``meg_init``; and the conjunctions of
``EventTable.query`` against pandas' ``query``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args

from brainmagick_tpu import dataset as jdataset
from brainmagick_tpu import play as jplay
from brainmagick_tpu import train as jtrain
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu.studies import fake as jfake
from brainmagick_tpu_torch import convert, dataset, play, train
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.events import EventTable
from brainmagick_tpu_torch.models.simpleconv import SimpleConv
from brainmagick_tpu_torch.solver import prepare_norm_arrays

#: the predictions' tolerance (rtol = atol), and the attention's
PREDICT_TOL = 1e-4
ATTENTION_TOL = 1e-5
#: the MEG's tolerance between the packages' preprocessing, as a share of
#: max|meg| (tests/test_torch_data.py)
MEG_TOL = 1e-5
SENTENCES = ("de kat slaapt in de woonkamer", "Toen barkeeper de",
             "een ongelooflijk langzame kwallenwedstrijd")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.mark.parametrize("features,sample_rate", [
    (("WordLength", "WordFrequency"), 20), (("WordLength",), 120)])
def test_sentence_features_equal_the_jax_packages(features, sample_rate):
    """The same events (times, durations, columns) and the same painted
    features for typed sentences and for given durations, to 1e-6."""
    want = jplay.SentenceFeatures(list(features), {}, sample_rate=sample_rate)
    got = play.SentenceFeatures(list(features), {}, sample_rate=sample_rate)
    for sentence in SENTENCES:
        a, b = got(sentence), want(sentence)
        assert a.shape == b.shape and a.shape[0] == len(features)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert (a[:, :sample_rate] == 0).all()     # the first word at 1 s
    durations = [("hallo", 0.5), ("wereld", 0.25), ("x", 1.5)]
    np.testing.assert_allclose(got.generate(durations, interword=0.2),
                               want.generate(durations, interword=0.2),
                               rtol=1e-6, atol=1e-6)
    events = got._generate_events(durations)
    frame = want._generate_events(durations)
    for name in ("start", "duration", "word_index", "sequence_uid"):
        np.testing.assert_allclose(events[name].astype(float),
                                   frame[name].to_numpy(float), rtol=1e-12)
    for name in ("word", "language", "modality", "kind", "word_sequence"):
        assert events[name].tolist() == frame[name].tolist(), name


def test_query_conjunctions_equal_pandas():
    """``EventTable.query`` of one ``field==value`` term or of terms joined
    by ``&`` selects pandas' rows; other forms raise."""
    frame = jfake.make_fake_events(total_duration=200, seed=1234)
    table = EventTable.from_records(frame.to_dict("records"))
    for query in ("kind=='word' & word_index==0", "kind=='word'",
                  "kind == 'phoneme'&modality=='audio'",
                  "word_index==2 & kind=='word' & modality=='visual'",
                  "kind=='block' & word_index==0"):
        want = frame.query(query)
        got = table.query(query)
        assert len(got) == len(want), query
        np.testing.assert_array_equal(got["start"], want["start"].to_numpy())
    assert len(table.query("kind=='word' & word_index==0")) > 1
    for bad in ("kind=='word' | word_index==0", "kind=='word' &",
                "word_index > 0", "kind=='word' and word_index==0"):
        with pytest.raises(NotImplementedError):
            table.query(bad)


@pytest.fixture(scope="module")
def solvers(tmp_path_factory):
    """The JAX package's tiny solvers and the port's from the same weights
    and normalization arrays: the encode task (mse), and decoding one word
    feature with the fused head (the port's also unfused)."""
    root = tmp_path_factory.mktemp("play")
    cache = root / "fake_cache"
    cache.mkdir()
    out = {"cache": cache}
    with jenv.temporary(cache=cache), env.temporary(cache=cache):
        for name, kwargs, options in (
                ("encode", dict(loss="mse", task="encode"), {}),
                ("fused", dict(loss="mse", features=("WordLength",)),
                 dict(fused_head=True))):
            jargs = tiny_args(cache, root / name, epochs=1, **kwargs)
            jargs.simpleconv.update(merger_dropout=0., **options)
            jsolver = jtrain.get_solver(jargs, training=False)
            out[name] = (jsolver, _port_solver(jargs, jsolver, cache))
        jargs.simpleconv.update(fused_head=False)
        out["unfused"] = _port_solver(jargs, out["fused"][0], cache)
    yield types.SimpleNamespace(**out)


def _port_solver(jargs, jsolver, cache):
    """The port's solver of `jargs` on the CPU with `jsolver`'s weights
    and normalization arrays."""
    args = train.parse_overrides(
        [f"{k}={v!r}" for k, v in jargs.delta().items()]
        + [f"cache={cache}", f"out_dir={jargs.out_dir}", "device=cpu"])
    solver = train.get_solver(args, training=False)
    state = jax.device_get(jsolver.state)
    convert.load_jax_params(solver.model, state["params"],
                            state["batch_stats"])
    solver.norm_arrays = prepare_norm_arrays(
        solver.model, {k: None if v is None else np.asarray(v)
                       for k, v in jsolver.norm_arrays.items()}, "cpu")
    return solver


def test_basal_state_windows_equal_the_jax_packages(solvers):
    """``extract_basal_states`` of each fake recording: the same windows
    (first words of sentences, the samples before them) and their MEG
    within MEG_TOL of max|meg|."""
    jsolver, solver = solvers.encode
    dst = solver.args.dset
    with jenv.temporary(cache=solvers.cache), \
            env.temporary(cache=solvers.cache):
        want = list(jdataset._extract_recordings(
            [jsolver.args.selections[x] for x in dst.selections],
            n_recordings=dst.n_recordings))
        got = list(dataset._extract_recordings(
            [solver.args.selections[x] for x in dst.selections],
            n_recordings=dst.n_recordings))
        for jrec, rec in zip(want, got):
            jbasal = jplay.SentenceFeatures.from_solver(
                jsolver).extract_basal_states(jrec, duration=0.3)
            basal = play.SentenceFeatures.from_solver(
                solver).extract_basal_states(rec, duration=0.3)
            assert len(basal) == len(jbasal) > 1
            np.testing.assert_array_equal(basal.event_samples,
                                          jbasal.event_samples)
            for k in (0, len(basal) - 1):
                a, b = basal[k].meg, np.asarray(jbasal[k].meg)
                assert a.shape == b.shape == (a.shape[0], 37)
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=MEG_TOL * np.abs(b).max())


def test_attention_map_equals_the_jax_packages(solvers):
    """The merger's attention of every recording, to ATTENTION_TOL, each
    row a distribution over the sensors; without a merger it raises."""
    jsolver, solver = solvers.fused
    want, want_pos = jplay.attention_map(jsolver)
    got, positions = play.attention_map(solver)
    assert got.shape == want.shape and got.shape[1] == 16
    np.testing.assert_array_equal(positions, want_pos)
    np.testing.assert_allclose(got, want, rtol=ATTENTION_TOL,
                               atol=ATTENTION_TOL)
    np.testing.assert_allclose(got.sum(-1), 1., rtol=1e-5)
    bare = SimpleConv(in_channels={"meg": 20}, out_channels=8, hidden={
        "meg": 8}, depth=1, merger=False, n_subjects=2)
    with pytest.raises(ValueError, match="merger"):
        play.attention_map(types.SimpleNamespace(model=bare,
                                                 norm_arrays={}))


def test_attention_map_per_subject_heads(solvers):
    """Per-subject merger heads [S, O, D]: both packages average them over
    the subjects, to ATTENTION_TOL; a recording's sensors without a
    position weigh 0 and the others sum to 1."""
    jsolver, solver = solvers.fused
    kw = dict(in_channels={"meg": solver.model.in_channels["meg"]},
              out_channels=8, n_subjects=3, hidden={"meg": 8}, depth=1,
              merger=True, merger_channels=16, merger_pos_dim=32,
              merger_per_subject=True)
    n = solver.model.in_channels["meg"]
    variables = JaxSimpleConv(**kw).init(
        jax.random.PRNGKey(2), {"meg": jnp.zeros((2, n, 40))},
        jnp.zeros(2, jnp.int32), jnp.zeros((2, n, 2)))
    params = jax.device_get(variables["params"])
    assert params["ChannelMerger_0"]["heads"].ndim == 3
    model = SimpleConv(**kw)
    convert.load_jax_params(model, {"model": params},
                            {"model": jax.device_get(
                                variables.get("batch_stats", {}))})
    arrays = {k: np.array(v) for k, v in jsolver.norm_arrays.items()
              if k in ("rec_positions", "pos_emb")}
    arrays["rec_positions"][1, -5:] = -0.1          # sensors without one
    want, _ = jplay.attention_map(types.SimpleNamespace(
        state={"params": {"model": params}}, norm_arrays=arrays))
    got, positions = play.attention_map(types.SimpleNamespace(
        model=model, norm_arrays=prepare_norm_arrays(model, arrays, "cpu")))
    np.testing.assert_allclose(got, want, rtol=ATTENTION_TOL,
                               atol=ATTENTION_TOL)
    invalid = (positions == -0.1).all(-1)
    assert invalid.sum() == 5 and (got.transpose(0, 2, 1)[invalid] == 0).all()
    np.testing.assert_allclose(got.sum(-1), 1., rtol=1e-5)


def test_solver_predict_equals_the_jax_packages(solvers):
    """``Solver.predict`` of a test window's features under each subject,
    as numpy [F, T'], within PREDICT_TOL, on zero MEG and on given MEG."""
    jsolver, solver = solvers.encode
    feats = jsolver.datasets.test[0].features
    assert feats.shape[0] == solver.used_features.dimension
    meg = np.random.RandomState(0).randn(
        jsolver.datasets.train[0].meg.shape[0], feats.shape[1]).astype(
        np.float32)
    for kwargs in (dict(subject_index=0), dict(subject_index=1, meg=meg)):
        want = np.asarray(jsolver.predict(features=feats, **kwargs))
        got = solver.predict(features=feats, **kwargs)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=PREDICT_TOL,
                                   atol=PREDICT_TOL)


def test_fused_head_predict_honors_subject(solvers):
    """The fused head pairs recording 0 with the batch's subject, as the
    unfused subject layers do (tests/test_solver.py's case): the port's
    fused and unfused predictions agree within PREDICT_TOL and with the
    JAX package's fused ones, and the subject matters."""
    jsolver, fused = solvers.fused
    assert fused.model.fused_head and not solvers.unfused.model.fused_head
    feats = fused.datasets.test[0].features[:1]
    preds = {}
    for subject in (0, 1):
        got = fused.predict(features=feats, subject_index=subject,
                            recording_index=0)
        np.testing.assert_allclose(
            got, solvers.unfused.predict(features=feats,
                                         subject_index=subject,
                                         recording_index=0),
            rtol=PREDICT_TOL, atol=PREDICT_TOL)
        np.testing.assert_allclose(
            got, np.asarray(jsolver.predict(features=feats,
                                            subject_index=subject,
                                            recording_index=0)),
            rtol=PREDICT_TOL, atol=PREDICT_TOL)
        preds[subject] = got
    assert not np.allclose(preds[0], preds[1], atol=1e-5)


@pytest.mark.parametrize("meg_init", [False, True])
def test_play_predict_equals_the_jax_packages(solvers, meg_init):
    """``play.predict`` of a typed sentence's features: the zero-features
    prediction less the sentence's, averaged over the recordings (and of
    one subject), within PREDICT_TOL; with ``meg_init`` on each
    recording's basal MEG."""
    jsolver, solver = solvers.encode
    features = play.SentenceFeatures.from_solver(solver)(SENTENCES[1])
    np.testing.assert_allclose(
        features, jplay.SentenceFeatures.from_solver(jsolver)(SENTENCES[1]),
        rtol=1e-6, atol=1e-6)
    features = features.astype(np.float32)
    with jenv.temporary(cache=solvers.cache), \
            env.temporary(cache=solvers.cache):
        for subject in (None, 1):
            want = jplay.predict(jsolver, features, subject_index=subject,
                                 meg_init=meg_init)
            got = play.predict(solver, features, subject_index=subject,
                               meg_init=meg_init)
            assert got.shape == np.asarray(want).shape
            assert np.abs(got).max() > 0
            np.testing.assert_allclose(got, np.asarray(want),
                                       rtol=PREDICT_TOL, atol=PREDICT_TOL)
