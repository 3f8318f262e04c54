"""The PyTorch port's word features and YIN pitch against the JAX package:
hash_embedding and compute_yin bit for bit, the rule-based tagger, the
WordEmbedding / WordEmbeddingSmall / PartOfSpeech tracks of a fake
recording, BertEmbedding and XlmEmbedding on a tiny local BERT (built
from local files, no download), the builder's study rule for the offline
stand-ins in both packages (a real study refuses them before any step),
the Pitch track through the resampler, and the track cache's key, which
names each word feature's model or stand-in."""

import wave

import numpy as np
import pandas as pd
import pytest
import torch
from test_embeddings import tiny_bert  # noqa: F401  (a fixture)

from brainmagick_tpu import cache as jcache
from brainmagick_tpu import events as jevents
from brainmagick_tpu.features import FeaturesBuilder as JaxBuilder
from brainmagick_tpu.features import audio as jaudio
from brainmagick_tpu.features import embeddings as jemb
from brainmagick_tpu.studies import fake as jfake
from brainmagick_tpu.utils import Frequency as JaxFrequency
from brainmagick_tpu_torch import cache, events
from brainmagick_tpu_torch.features import FeaturesBuilder
from brainmagick_tpu_torch.features import audio, embeddings as emb
from brainmagick_tpu_torch.studies import fake
from brainmagick_tpu_torch.utils import Frequency

WORD_FEATURES = ("WordEmbedding", "WordEmbeddingSmall", "PartOfSpeech",
                 "BertEmbedding", "XlmEmbedding")
WORDS = ["the", "The", "cat", "Amsterdam", "walking", "jumped", "quickly",
         "de", "niet", "zijn", "42", "x1", "...", "-", "don't", "",
         "éléphant", "Straße", "ünïcödé", "word " * 3]
#: the share of Pitch frames allowed to differ from JAX's: YIN picks an
#: integer lag against a threshold, so an fp32 difference in the
#: resampled wave may move a frame near the threshold by a lag or across
#: the voicing decision
PITCH_FRAME_TOL = 0.01


@pytest.fixture(autouse=True)
def _fresh_model_caches(monkeypatch):
    """Each test starts without loaded models: the spacy and transformers
    loaders' memory caches are emptied (tests may plant models)."""
    monkeypatch.setattr(jcache.MemoryCache, "_CACHE", {})
    monkeypatch.setattr(cache.MemoryCache, "_CACHE", {})


def test_constants_are_the_jax_packages():
    assert emb.UPOS_TAGS == jemb.UPOS_TAGS
    assert emb._SPACY_MODELS == jemb._SPACY_MODELS
    assert emb._CLOSED_CLASS == jemb._CLOSED_CLASS
    assert FeaturesBuilder._FALLBACK_STUDIES == JaxBuilder._FALLBACK_STUDIES
    for name in WORD_FEATURES:
        port = FeaturesBuilder._FEATURE_CLASSES[name]
        jax_cls = JaxBuilder._FEATURE_CLASSES[name]
        assert (port.dimension, port.cardinality, port.event_kind) \
            == (jax_cls.dimension, jax_cls.cardinality, jax_cls.event_kind)
    for name in ("BertEmbedding", "XlmEmbedding"):
        port = FeaturesBuilder._FEATURE_CLASSES[name]
        jax_cls = JaxBuilder._FEATURE_CLASSES[name]
        assert (port.model_name, port.layers, port.token_pooling) \
            == (jax_cls.model_name, jax_cls.layers, jax_cls.token_pooling)


@pytest.mark.parametrize("dim", [1, 96, 300, 768, 1024])
def test_hash_embedding_is_bit_equal(dim):
    """sha1 -> RandomState -> randn -> unit norm, bit for bit."""
    for word in WORDS[:-2] + ["a" * 200]:
        got = emb.hash_embedding(word, dim)
        want = jemb.hash_embedding(word, dim)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emb.hash_embedding("Cat", dim),
                                  emb.hash_embedding("cat", dim))


@pytest.mark.parametrize("language", ["en", "nl", "english", "dutch", "fr"])
def test_rule_based_pos_equals_the_jax_packages(language):
    """Both languages' closed classes, digits, punctuation, the English
    suffix rules and capitals, and an unknown language (English rules)."""
    words = WORDS + [w for table in jemb._CLOSED_CLASS.values()
                     for w in table] + ["Walking", "Blue", "ßing"]
    got = [emb.rule_based_pos(w, language) for w in words]
    assert got == [jemb.rule_based_pos(w, language) for w in words]
    assert set(got) <= set(emb.UPOS_TAGS)


def _fake_tables(duration=40., seed=1236):
    return (jfake.make_fake_events(total_duration=duration, seed=seed),
            fake.make_fake_events(total_duration=duration, seed=seed))


@pytest.mark.parametrize("name", ["WordEmbedding", "WordEmbeddingSmall",
                                  "PartOfSpeech"])
def test_word_tracks_equal_the_jax_packages(name):
    """The feature painted over a fake recording (Dutch words, hash
    embeddings and the rule-based tagger) equals the JAX package's track,
    with the word mask; the languages give a backend of FALLBACK."""
    frame, table = _fake_tables()
    want = JaxBuilder(frame, [name], None, JaxFrequency(120.),
                      event_mask=True, study="fake")
    got = FeaturesBuilder(table, [name], None, Frequency(120.),
                          event_mask=True, study="fake")
    assert got.output_dimension == want.output_dimension
    want_data, want_mask = want.render_track(40.)
    got_data, got_mask = got.render_track(40.)
    np.testing.assert_array_equal(got_data, want_data)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert (got_data != 0).any()
    assert got.backends() == {name: {"nl": emb.FALLBACK}}


def _words(module, cases):
    return [module.Word(start=0., duration=.2, modality="audio",
                        language="english", word=word, word_index=index,
                        word_sequence=sequence)
            for word, index, sequence in cases]


#: the words of the contextual checks: single and multi-token words, a
#: repeated word, a bad word_index (the whole sequence is pooled), an
#: index past the sequence, a word with no tokens and an empty word
CONTEXT_CASES = [("cat", 1, "the cat sat"), ("cat", 1, "a cat ran"),
                 ("unbelievable", 1, "the unbelievable story"),
                 ("the", 3, "the cat sat on the mat"),
                 ("dog", 5, "the cat sat"), ("story", 9, "a story"),
                 ("mat", 0, "mat"), ("", 0, "")]


@pytest.mark.parametrize("contextual", [True, False],
                         ids=["contextual", "embedding_layer"])
@pytest.mark.parametrize("name", ["BertEmbedding", "XlmEmbedding"])
def test_contextual_embeddings_equal_the_jax_packages(
        tiny_bert, monkeypatch, name, contextual):  # noqa: F811
    """The tiny BERT of tests/test_embeddings.py behind both packages'
    feature (layers 1-2 for BertEmbedding, as that test sets them): the
    token-to-word alignment and pooling give the same vectors, bit for
    bit, contextual and not, a bad word_index included."""
    features = []
    for builder, freq in ((FeaturesBuilder, Frequency(50)),
                          (JaxBuilder, JaxFrequency(50))):
        feat = builder._FEATURE_CLASSES[name](freq, contextual=contextual)
        feat.dimension = 16
        if name == "BertEmbedding":
            feat.layers = (1, 2)
        monkeypatch.setattr(feat, "_load", lambda: tiny_bert)
        features.append(feat)
    port, jax_feat = features
    assert port.backend(["en"]) == port.model_name
    for got_event, want_event in zip(_words(events, CONTEXT_CASES),
                                     _words(jevents, CONTEXT_CASES)):
        got, want = port.get(got_event), jax_feat.get(want_event)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == (16,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["BertEmbedding", "XlmEmbedding"])
def test_contextual_fallback_equals_the_jax_packages(monkeypatch, name):
    """With no checkpoint on disk both packages give the word's hash
    embedding, per word whatever its context."""
    port = FeaturesBuilder._FEATURE_CLASSES[name](Frequency(50))
    jax_feat = JaxBuilder._FEATURE_CLASSES[name](JaxFrequency(50))
    for feat in (port, jax_feat):
        monkeypatch.setattr(feat, "_load", lambda: None)
    assert port.backend(["en"]) == emb.FALLBACK
    for got_event, want_event in zip(_words(events, CONTEXT_CASES),
                                     _words(jevents, CONTEXT_CASES)):
        got, want = port.get(got_event), jax_feat.get(want_event)
        assert got.shape == (port.dimension,)
        np.testing.assert_array_equal(got, want)


#: (study, features_params' allow_fallback) -> whether the stand-in is
#: allowed: the synthetic studies and direct use allow it, a real study
#: refuses it, and an explicit flag wins in both directions
STUDY_RULE = [("fake", None, True), ("fakeeeg", None, True),
              (None, None, True), ("gwilliams2022", None, False),
              ("schoffelen2019", None, False), ("gwilliams2022", True, True),
              ("fake", False, False)]


@pytest.mark.parametrize("study,flag,allowed", STUDY_RULE, ids=str)
def test_study_rule_equals_the_jax_packages(monkeypatch, study, flag,
                                            allowed):
    """Every word feature, with no model on disk: both builders resolve
    allow_fallback alike, and both features give the same stand-in or
    both raise MissingModelError."""
    monkeypatch.setattr(emb, "_try_spacy", lambda lang: None)
    monkeypatch.setattr(jemb, "_try_spacy", lambda lang: None)
    rows = [dict(kind="word", start=0., duration=.2, modality="audio",
                 language="english", word="cat", word_index=0,
                 word_sequence="cat")]
    params = None if flag is None else {
        name: {"allow_fallback": flag} for name in WORD_FEATURES}
    port = FeaturesBuilder(events.EventTable.from_records(rows),
                           WORD_FEATURES, params, Frequency(50), study=study)
    want = JaxBuilder(pd.DataFrame(rows), WORD_FEATURES, params,
                      JaxFrequency(50), study=study)
    got_event, want_event = (module.Word(**{k: v for k, v in rows[0].items()
                                            if k != "kind"})
                             for module in (events, jevents))
    for name in WORD_FEATURES:
        feat, jax_feat = port[name], want[name]
        for f in (feat, jax_feat):
            if hasattr(f, "_load"):
                monkeypatch.setattr(f, "_load", lambda: None)
        assert feat.allow_fallback is jax_feat.allow_fallback is allowed
        if allowed:
            np.testing.assert_array_equal(feat.get(got_event),
                                          jax_feat.get(want_event))
        else:
            with pytest.raises(emb.MissingModelError, match="allow_fallback"):
                feat.get(got_event)
            with pytest.raises(jemb.MissingModelError,
                               match="allow_fallback"):
                jax_feat.get(want_event)


def test_real_study_refuses_the_stand_ins_before_any_step(tmp_path):
    """A gwilliams2022 tree (KIT raws) with WordEmbedding and no spacy
    model: both packages' get_solver raise MissingModelError while the
    datasets and the scaler are built, before a step; with
    allow_fallback=true the port's builds."""
    from test_torch_study_training import BASE, STUDIES, \
        write_gwilliams_kit_tree

    from brainmagick_tpu import train as jtrain
    from brainmagick_tpu.env import env as jenv
    from brainmagick_tpu_torch import train
    from brainmagick_tpu_torch.env import env

    root = tmp_path / "gwilliams2022"
    write_gwilliams_kit_tree(root)
    (tmp_path / "fake_cache").mkdir()
    overrides = [o for o in BASE if not o.startswith("dset.features")] + [
        'dset.features=["WordEmbedding"]', 'dset.selections=["gwilliams2022"]',
        "optim.loss=mse", f"cache={tmp_path / 'fake_cache'}",
        f"out_dir={tmp_path / 'outputs'}", *STUDIES["gwilliams2022"]]
    studies = {"gwilliams2022": root}
    with jenv.temporary(studies=studies):
        with pytest.raises(jemb.MissingModelError, match="allow_fallback"):
            jtrain.get_solver(jtrain.parse_overrides(overrides))
    with env.temporary(studies=studies):
        with pytest.raises(emb.MissingModelError, match="allow_fallback"):
            train.get_solver(train.parse_overrides(overrides
                                                   + ["device=cpu"]))
        solver = train.get_solver(train.parse_overrides(overrides + [
            "device=cpu", 'dset.features_params={"WordEmbedding": '
            '{"allow_fallback": True}}']))
    assert solver.used_features["WordEmbedding"].allow_fallback is True


class _Vectors:
    """A stand-in spacy pipeline: a seeded 300-d vector per word."""

    def __call__(self, word):
        vector = np.random.RandomState(len(word)).randn(300).astype(
            np.float32)
        return type("Doc", (), {"vector": vector})()


def test_track_cache_key_names_the_backend(tmp_path, monkeypatch):
    """A WordEmbedding track rendered on hash embeddings is cached; once a
    spacy model is there (a new process: the loaders' memory caches
    empty) the key differs, so the track is rendered anew from the
    model's vectors instead of served from the cache. A track of
    features that have no model keeps the key it had."""
    from brainmagick_tpu_torch import train
    from brainmagick_tpu_torch.env import env

    folder = tmp_path / "fake_cache"
    folder.mkdir()
    args = train.parse_overrides([
        'dset.selections=["fake"]', "dset.n_recordings=1",
        'dset.features=["WordEmbedding"]', "dset.condition=1.0",
        "dset.test_ratio=0.3", "dset.valid_ratio=0.2",
        "dset.min_n_blocks_per_split=1", "optim.loss=mse",
        f"cache={folder}", "device=cpu", "num_workers=1"])

    def track():
        with env.temporary(cache=folder):
            dset = train.build_datasets(args).train.datasets[0]
            data, _ = dset._get_track()
            sl = dset.features.get_slice("WordEmbedding")
            return np.array(data[sl]), dset.features.backends()

    hashed, backends = track()
    assert backends == {"WordEmbedding": {"nl": emb.FALLBACK}}
    entries = sorted((folder / "feature_tracks").rglob("*.npy"))
    again, _ = track()
    np.testing.assert_array_equal(again, hashed)
    assert sorted((folder / "feature_tracks").rglob("*.npy")) == entries

    monkeypatch.setattr(emb, "_try_spacy", lambda lang: _Vectors())
    monkeypatch.setattr(cache.MemoryCache, "_CACHE", {})
    modelled, backends = track()
    assert backends == {"WordEmbedding": {"nl": "nl_core_news_md"}}
    assert len(sorted((folder / "feature_tracks").rglob("*.npy"))) \
        == len(entries) + 1
    painted = np.abs(hashed).sum(0) > 0
    assert not np.array_equal(modelled[:, painted], hashed[:, painted])


@pytest.mark.parametrize("params", [(512, 256, 100., 500., 0.1),
                                    (256, 64, 100., 350., 0.1),
                                    (400, 100, 80., 300., 0.3)], ids=str)
def test_compute_yin_is_bit_equal(params):
    """The same float64 signal through both packages' YIN: pitches,
    harmonic rates, argmins and times bit for bit."""
    w_len, w_step, f0_min, f0_max, thresh = params
    rng = np.random.RandomState(7)
    sr = 16000
    t = np.arange(sr) / sr
    f0 = 150 + 50 * np.sin(2 * np.pi * 0.8 * t)
    sig = np.sin(np.cumsum(2 * np.pi * f0 / sr)) * (t > 0.2) \
        + 0.1 * rng.randn(sr)
    got = audio.compute_yin(sig, sr, w_len, w_step, f0_min, f0_max, thresh)
    want = jaudio.compute_yin(sig, sr, w_len, w_step, f0_min, f0_max,
                              thresh)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (np.asarray(got[0]) > 0).any() and (np.asarray(got[0]) == 0).any()
    assert audio.compute_yin(sig[:100], sr) == ([0.0], [0.0], [0.0], [0.0])


def test_compute_yin_on_sine():
    """tests/test_features.py's 220 Hz sine: the voiced frames' median
    within 5 Hz of 220."""
    sr = 16000
    t = np.arange(sr) / sr
    sig = np.sin(2 * np.pi * 220. * t)
    pitches, _, _, _ = audio.compute_yin(sig, sr, w_len=512, w_step=256,
                                         f0_min=100, f0_max=400)
    voiced = np.asarray(pitches)[np.asarray(pitches) > 0]
    assert len(voiced) > 10
    assert abs(np.median(voiced) - 220.) < 5


def _stereo_wav(path, sr, seconds=6.):
    """A seeded stereo speech-like wav at `sr`: a wandering pitch with
    harmonics, an envelope and noise."""
    rng = np.random.RandomState(3)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    phase = np.cumsum(2 * np.pi * (150 + 60 * np.sin(np.pi * t)) / sr)
    sig = sum(a * np.sin(h * phase) for h, a in ((1, .5), (2, .3), (3, .2)))
    sig = .5 * (1 + np.sin(2 * np.pi * 2.3 * t)) * sig + .05 * rng.randn(n)
    pcm = np.stack([sig, .8 * sig + .02 * rng.randn(n)], 1)
    pcm = (pcm / np.abs(pcm).max() * .9 * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return path


@pytest.mark.parametrize("sr", [8000, 16000, 22050, 44100, 48000])
def test_pitch_track_matches_jax(tmp_path, sr):
    """Pitch of a stereo wav (the mono mix resampled to 16 kHz by each
    package's resampler, then YIN at frame 256, step 64) against the JAX
    package's: at most PITCH_FRAME_TOL of the frames differ (none did on
    these wavs), and the painted track of the event likewise."""
    path = _stereo_wav(tmp_path / f"speech{sr}.wav", sr)
    got = audio.Pitch(Frequency(120.))._compute(str(path), 0.5, 5.5)
    want = jaudio.Pitch(JaxFrequency(120.))._compute(str(path), 0.5, 5.5)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    differ = int((got != want).sum())
    print(f"Pitch at {sr} Hz: {differ} of {len(want)} frames differ, "
          f"{int((want > 0).sum())} voiced")
    assert differ <= PITCH_FRAME_TOL * len(want)
    assert (want > 0).sum() > len(want) / 4

    rows = [dict(kind="sound", start=1., duration=4., filepath=str(path),
                 offset=.5, modality=None, language=None)]
    port = FeaturesBuilder(events.EventTable.from_records(rows), ["Pitch"],
                           None, Frequency(120.))
    jax_builder = JaxBuilder(pd.DataFrame(rows), ["Pitch"], None,
                             JaxFrequency(120.))
    got_track, _ = port.render_track(6.)
    want_track, _ = jax_builder.render_track(6.)
    assert (got_track != want_track).sum() \
        <= PITCH_FRAME_TOL * (want_track != 0).sum()
    assert port.backends() == {}
