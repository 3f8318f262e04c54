"""The port's wav2vec 2.0 encoder (brainmagick_tpu_torch.models.wav2vec2)
and its features (Wav2VecTransformer, Wav2VecConvolution, Wav2VecChunk
with random=True) against the JAX package's flax encoder, HF's
``Wav2Vec2Model`` and the JAX package's features, on the CPU.

No test reads a checkpoint or reaches the network: HF's
``from_pretrained`` is replaced by one that raises OSError, as it does on
an offline host, so the JAX package builds its literal xlsr-53 config."""

import dataclasses
import json
import threading
import types
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from brainmagick_tpu import cache as jcache  # noqa: E402
from brainmagick_tpu.env import env as jenv  # noqa: E402
from brainmagick_tpu.features import FeaturesBuilder as JaxBuilder  # noqa
from brainmagick_tpu.features import audio as jaudio  # noqa: E402
from brainmagick_tpu.models import wav2vec2 as jw2v  # noqa: E402
from brainmagick_tpu.studies import fake as jfake  # noqa: E402
from brainmagick_tpu.utils import Frequency as JaxFrequency  # noqa: E402
from brainmagick_tpu_torch import cache, convert, train  # noqa: E402
from brainmagick_tpu_torch.env import env  # noqa: E402
from brainmagick_tpu_torch.features import FeaturesBuilder  # noqa: E402
from brainmagick_tpu_torch.features import audio  # noqa: E402
from brainmagick_tpu_torch.models import wav2vec2 as w2v  # noqa: E402
from brainmagick_tpu_torch.studies import fake  # noqa: E402
from brainmagick_tpu_torch.utils import Frequency  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "wav2vec2_xlsr53_init_sha256.json"
#: the encoder against flax's and HF's on the same weights: the tolerance
#: of the JAX package's own flax-vs-HF test (tests/test_wav2vec2.py)
ENCODER_RTOL, ENCODER_ATOL = 1e-3, 2e-4
#: a feature's output against the JAX package's (its resample in jax, the
#: 24 layers of HF's sdpa attention), as a share of the output's max |x|
#: (9.1e-7 for the transformer's layers at full width)
FEATURE_TOL = 1e-5
#: Wav2VecChunk when the wav needs resampling (jax's resample against
#: torch's), as a share of max |x|
CHUNK_TOL = 1e-5
NAME = "facebook/wav2vec2-large-xlsr-53"
#: a small config at the real conv strides (a 50 Hz output, which the
#: features assert for events of 0.5 s or more) and the features' widths
SMALL = w2v.Wav2Vec2Config(conv_dim=(8,) * 6 + (512,), hidden_size=1024,
                           num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=32, num_conv_pos_embeddings=16,
                           num_conv_pos_embedding_groups=16)


def _offline(*args, **kwargs):
    raise OSError("offline: no checkpoint on disk")


@pytest.fixture(autouse=True)
def offline_and_fresh(monkeypatch):
    """HF's from_pretrained raises OSError (no download is tried), and
    neither package keeps a wav2vec model after the test."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(transformers.Wav2Vec2Config, "from_pretrained",
                        classmethod(_offline))
    monkeypatch.setattr(transformers.Wav2Vec2Model, "from_pretrained",
                        classmethod(_offline))
    yield
    for memory in (jcache.MemoryCache, cache.MemoryCache):
        memory._CACHE.pop("Wav2VecEmbedding", None)


def hf_config(cfg: w2v.Wav2Vec2Config):
    return transformers.Wav2Vec2Config(
        conv_dim=list(cfg.conv_dim), conv_kernel=list(cfg.conv_kernel),
        conv_stride=list(cfg.conv_stride), conv_bias=cfg.conv_bias,
        hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        do_stable_layer_norm=cfg.do_stable_layer_norm,
        feat_extract_norm=cfg.feat_extract_norm)


def hf_seeded(cfg: w2v.Wav2Vec2Config, seed: int = w2v.seed_of(NAME)):
    """HF's model at `cfg`, seeded as the JAX package seeds it."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        return transformers.Wav2Vec2Model(hf_config(cfg)).eval()


def port_seeded(cfg: w2v.Wav2Vec2Config, seed: int = w2v.seed_of(NAME)):
    return w2v.Wav2Vec2Model(cfg, torch.Generator().manual_seed(seed)).eval()


VARIANTS = {"stable-layer": w2v.Wav2Vec2Config.tiny(),
            "postln-group": dataclasses.replace(
                w2v.Wav2Vec2Config.tiny(), do_stable_layer_norm=False,
                feat_extract_norm="group")}


def _wav(batch: int = 2, n: int = 800) -> np.ndarray:
    return np.random.RandomState(0).randn(batch, n).astype(np.float32)


def _close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=ENCODER_RTOL, atol=ENCODER_ATOL,
                               err_msg=what)


@pytest.mark.parametrize("scan", [False, True], ids=["per-layer", "scan"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encoder_matches_flax_on_bridged_weights(variant, scan):
    """The flax tree of the JAX package's encoder (from HF's weights by
    its convert_torch_weights, per layer or stacked for nn.scan) loaded
    by the port's rules: every leaf consumed, the outputs of flax's
    apply."""
    import jax.numpy as jnp

    cfg = VARIANTS[variant]
    hf = hf_seeded(cfg, seed=1)
    params = jw2v.convert_torch_weights(hf, scan_layers=scan)
    flax = jw2v.Wav2Vec2Model(jw2v.config_from_hf(hf.config,
                                                  scan_layers=scan))
    port = port_seeded(cfg, seed=2)
    convert.load_wav2vec2_flax(port, params)
    wav = _wav()
    last_j, extract_j, hidden_j = flax.apply({"params": params},
                                             jnp.asarray(wav))
    with torch.no_grad():
        last, extract, hidden = port(torch.from_numpy(wav))
    _close(extract, extract_j, "extract_features")
    assert len(hidden) == len(hidden_j) == cfg.num_hidden_layers + 1
    for k, (got, want) in enumerate(zip(hidden, hidden_j)):
        _close(got, want, f"hidden state {k}")
    _close(last, last_j, "last hidden state")
    # the flax tree's leaves are HF's weights, moved back by the rules
    state = hf.state_dict()
    for key, value in port.state_dict().items():
        hf_key = key.replace("weight_g", "parametrizations.weight.original0")
        hf_key = hf_key.replace("weight_v", "parametrizations.weight.original1")
        if key != "masked_spec_embed":
            torch.testing.assert_close(value, state[hf_key], rtol=0, atol=0)


def test_bridge_refuses_a_leaf_it_does_not_read():
    hf = hf_seeded(VARIANTS["stable-layer"])
    params = jw2v.convert_torch_weights(hf)
    params["layers_0"]["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="map onto no port weight"):
        convert.load_wav2vec2_flax(port_seeded(VARIANTS["stable-layer"]),
                                   params)


@pytest.mark.parametrize("names", ["parametrizations", "weight_g"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encoder_matches_hf_on_its_state_dict(variant, names):
    """HF's state dict (the weight-norm pair under either of torch's
    names) loaded by name: extract_features, every hidden state and the
    last one of HF's forward; a selection of hidden states keeps those
    indices in that order."""
    cfg = VARIANTS[variant]
    hf = hf_seeded(cfg, seed=3)
    state = {k: v.numpy() for k, v in hf.state_dict().items()}
    if names == "weight_g":
        state = {k.replace("parametrizations.weight.original0", "weight_g")
                 .replace("parametrizations.weight.original1", "weight_v"): v
                 for k, v in state.items()}
    port = port_seeded(cfg, seed=4)
    convert.load_wav2vec2_state_dict(port, state)
    wav = torch.from_numpy(_wav(n=1200))
    with torch.no_grad():
        want = hf(wav, output_hidden_states=True)
        last, extract, hidden = port(wav)
        _, _, picked = port(wav, layers=[2, 0])
    _close(extract, want.extract_features, "extract_features")
    assert len(hidden) == len(want.hidden_states)
    for k, (got, ref) in enumerate(zip(hidden, want.hidden_states)):
        _close(got, ref, f"hidden state {k}")
    _close(last, want.last_hidden_state, "last hidden state")
    assert torch.equal(picked[0], hidden[2])
    assert torch.equal(picked[1], hidden[0])
    with pytest.raises(ValueError):
        port(wav, layers=[3])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_blocked_attention_matches_one_block_and_hf(variant, monkeypatch):
    """With ``ATTENTION_BYTES`` cut so that a forward's scores take 8
    query rows a block (the last block short), as a minutes-long sound
    event's do at full width: every hidden state equals the one-block
    forward's to 1e-6 of its max |x| and HF's at the encoder tolerance."""
    cfg = VARIANTS[variant]
    hf = hf_seeded(cfg, seed=3)
    port = port_seeded(cfg, seed=4)
    convert.load_wav2vec2_state_dict(
        port, {k: v.numpy() for k, v in hf.state_dict().items()})
    wav = torch.from_numpy(_wav(n=1200))
    with torch.no_grad():
        want = hf(wav, output_hidden_states=True)
        _, _, whole = port(wav)
        b, t = whole[0].shape[:2]
        rows = 8
        assert t % rows and t > 4 * rows
        monkeypatch.setattr(w2v, "ATTENTION_BYTES",
                            4 * b * cfg.num_attention_heads * t * rows)
        softmax, blocks = torch.softmax, []
        monkeypatch.setattr(torch, "softmax", lambda x, dim: (
            blocks.append(x.shape[2]), softmax(x, dim=dim))[1])
        _, _, blocked = port(wav)
    assert sorted(set(blocks)) == [t % rows, rows]
    assert len(blocks) == -(-t // rows) * cfg.num_hidden_layers
    for k, (got, one, ref) in enumerate(zip(blocked, whole,
                                            want.hidden_states)):
        assert float((got - one).abs().max() / one.abs().max()) <= 1e-6, k
        _close(got, ref, f"hidden state {k}, blocked")


@pytest.mark.parametrize("which", ["tiny", "postln-group", "xlsr53"])
def test_seeded_init_is_hfs_bit_for_bit(which):
    """The port's seeded init equals HF's seeded draws tensor for tensor,
    bit for bit, and takes nothing from torch's global generator; at the
    xlsr-53 config (315,435,136 parameters) the committed golden digest
    (scripts/torch_wav2vec2_digest.py) is live HF's."""
    cfg = {"tiny": w2v.Wav2Vec2Config.tiny(),
           "postln-group": VARIANTS["postln-group"],
           "xlsr53": w2v.Wav2Vec2Config.xlsr53()}[which]
    want = w2v.state_digest(hf_seeded(cfg).state_dict())
    torch.manual_seed(123)
    stream = torch.random.get_rng_state()
    port = port_seeded(cfg)
    assert torch.equal(torch.random.get_rng_state(), stream)
    got = w2v.state_digest(port.state_dict())
    assert list(got) == list(want)
    assert [k for k in want if got[k] != want[k]] == []
    if which == "xlsr53":
        assert sum(p.numel() for p in port.parameters()) == 315_435_136
        golden = json.loads(GOLDEN.read_text())
        assert golden["model"] == NAME
        assert golden["seed"] == w2v.seed_of(NAME) \
            == int.from_bytes(b"face", "big")
        assert golden["sha256"] == want


def test_config_is_the_jax_packages_literal_xlsr53():
    """The port's xlsr-53 config is the one the JAX package builds offline
    (HF's defaults and six overrides), field for field."""
    want = transformers.Wav2Vec2Config(
        hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
        intermediate_size=4096, do_stable_layer_norm=True,
        feat_extract_norm="layer")
    got = w2v.Wav2Vec2Config.xlsr53()
    for field in dataclasses.fields(got):
        value = getattr(want, field.name)
        assert getattr(got, field.name) == (
            tuple(value) if isinstance(value, list) else value), field.name
    tiny = jw2v.Wav2Vec2Config.tiny()
    port_tiny = w2v.Wav2Vec2Config.tiny()
    for field in dataclasses.fields(tiny):
        if hasattr(port_tiny, field.name):
            assert getattr(port_tiny, field.name) == getattr(
                tiny, field.name), field.name


def _write_wav(path: Path, seconds: float, sr: int, channels: int = 1,
               seed: int = 0) -> Path:
    """A speech-like 16-bit wav: a gliding tone under an envelope, plus
    noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = np.sin(2 * np.pi * (180 + 60 * np.sin(1.3 * t)) * t) \
        * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.2 * rng.randn(len(t))
    data = np.stack([sig * (1 - 0.3 * c) for c in range(channels)], axis=1)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(data, -2, 2) * 2 ** 13).astype("<i2")
                      .tobytes())
    return path


def _share(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_features_match_the_jax_packages_at_full_width(tmp_path):
    """Wav2VecTransformer(random=True) (the mean of layers 14-18) and
    Wav2VecConvolution on a 2 s stereo wav at 44.1 kHz, each package with
    its own seeded xlsr-53 network (the JAX package's default torch
    backend, HF's model), within FEATURE_TOL of max |x|; both features of
    a package share one model."""
    path = str(_write_wav(tmp_path / "speech.wav", 2.5, 44_100, 2))
    got_t = audio.Wav2VecTransformer(Frequency(120.), random=True)
    want_t = jaudio.Wav2VecTransformer(JaxFrequency(120.), random=True)
    layers = [14, 15, 16, 17, 18]
    got = got_t._compute_hidden_states("hidden_states", path, 0.25, 2.25,
                                       layers)
    want = want_t._compute_hidden_states("hidden_states", path, 0.25, 2.25,
                                         layers)
    assert got.shape == want.shape == (1, 99, 1024)
    assert got.dtype == want.dtype == np.float32
    print(f"Wav2VecTransformer: {_share(got, want):.2e} of max |x|")
    assert _share(got, want) < FEATURE_TOL
    got_c = audio.Wav2VecConvolution(Frequency(120.), random=True)
    want_c = jaudio.Wav2VecConvolution(JaxFrequency(120.), random=True)
    assert got_c.model is got_t.model
    got = got_c._compute_hidden_states("extract_features", path, 0.25, 2.25)
    want = want_c._compute_hidden_states("extract_features", path, 0.25,
                                         2.25)
    assert got.shape == want.shape == (1, 99, 512)
    print(f"Wav2VecConvolution: {_share(got, want):.2e} of max |x|")
    assert _share(got, want) < FEATURE_TOL


@pytest.fixture()
def small_configs(monkeypatch):
    """SMALL in both packages' random=True features."""
    monkeypatch.setattr(transformers.Wav2Vec2Config, "from_pretrained",
                        classmethod(lambda cls, name: hf_config(SMALL)))
    monkeypatch.setattr(w2v.Wav2Vec2Config, "xlsr53",
                        classmethod(lambda cls: SMALL))


PARAMS = {"Wav2VecTransformer": {"layers": [1, 2], "device": "cpu",
                                 "random": True},
          "Wav2VecConvolution": {"random": True}}


def test_feature_tracks_match_the_jax_packages(small_configs):
    """Both features painted by FeaturesBuilder over 40 s of the fake
    study (its sound events over the mock wav), SMALL patched into both
    packages: the port's tracks within FEATURE_TOL of the JAX package's,
    zero outside the sound events in both."""
    frame = jfake.make_fake_events(total_duration=40, seed=1236)
    table = fake.make_fake_events(total_duration=40, seed=1236)
    names = list(PARAMS)
    want = JaxBuilder(frame, names, PARAMS, JaxFrequency(120.))
    got = FeaturesBuilder(table, names, PARAMS, Frequency(120.))
    assert got.dimension == want.dimension == 1024 + 512
    want_data, _ = want.render_track(40.)
    got_data, _ = got.render_track(40.)
    assert got_data.shape == want_data.shape
    sounds = (want_data != 0).any(axis=0)
    assert sounds.mean() > 0.5
    np.testing.assert_array_equal((got_data != 0).any(axis=0), sounds)
    for name in names:
        rows = got.get_slice(name)
        print(f"{name}: {_share(got_data[rows], want_data[rows]):.2e}")
        assert _share(got_data[rows], want_data[rows]) < FEATURE_TOL


@pytest.mark.parametrize("sr", [16_000, 44_100])
def test_chunk_matches_the_jax_packages(tmp_path, sr):
    """Wav2VecChunk: the [1, T] normalized 16 kHz chunk of the event, its
    own 16 kHz rate whatever the builder's, not normalizable; bit-equal
    to the JAX package's when no resampling is needed."""
    path = _write_wav(tmp_path / f"s{sr}.wav", 3., sr, 2)
    event = types.SimpleNamespace(filepath=path, offset=0.5, duration=2.)
    got_f = audio.Wav2VecChunk(Frequency(120.), random=True)
    want_f = jaudio.Wav2VecChunk(JaxFrequency(120.), random=True)
    assert float(got_f.sample_rate) == float(want_f.sample_rate) == 16_000
    assert got_f.normalizable is want_f.normalizable is False
    assert got_f.dimension == want_f.dimension == 1
    got, want = got_f.get(event), want_f.get(event)
    assert got.shape == want.shape == (1, 32_000)
    assert got.dtype == want.dtype == np.float32
    if sr == 16_000:
        np.testing.assert_array_equal(got, want)
    else:
        assert _share(got, want) < CHUNK_TOL
    assert "Wav2VecChunk" in FeaturesBuilder._FEATURE_CLASSES


def test_random_false_raises_as_the_jax_package_does(tmp_path):
    """Without the pretrained checkpoint both packages raise RuntimeError
    at the first forward, and neither falls back to random weights."""
    path = str(_write_wav(tmp_path / "s.wav", 1., 16_000))
    with pytest.raises(RuntimeError, match="random=True"):
        jaudio.Wav2VecTransformer(JaxFrequency(120.))._compute_hidden_states(
            "hidden_states", path, 0., 1.)
    with pytest.raises(RuntimeError, match="random=True"):
        audio.Wav2VecTransformer(Frequency(120.))._compute_hidden_states(
            "hidden_states", path, 0., 1.)
    with pytest.raises(RuntimeError, match="get_on_overlap"):
        audio.Wav2VecTransformer(Frequency(120.), random=True).get(None)


def test_cache_entries_are_tagged_and_keyed_as_the_jax_packages(tmp_path):
    """The port's hidden-state cache: the JAX package's name and args
    ((name, random, "seeded")), under the port's backend tag, so the two
    packages never read each other's entries."""
    folder = tmp_path / "fake_cache"
    folder.mkdir()
    with env.temporary(cache=folder), jenv.temporary(cache=folder):
        got = audio.Wav2VecTransformer(Frequency(120.), random=True).cache
        want = jaudio.Wav2VecTransformer(JaxFrequency(120.),
                                         random=True).cache
        pretrained = audio.Wav2VecTransformer(Frequency(120.)).cache
    assert got.path.parent.name == want.path.parent.name \
        == "Wav2VecEmbedding"
    assert got.path.name == cache.tagged(cache.signature(
        [cache.BACKEND, (NAME, True, "seeded")]))
    assert got.path != want.path
    assert pretrained.path.name == cache.tagged(cache.signature(
        [cache.BACKEND, NAME]))


def test_the_forward_runs_in_fp32_under_the_lock(small_configs, tmp_path):
    """The encoder sees TF32 off and holds the forward lock (the scaler
    fit renders tracks in threads); the flags come back after."""
    path = str(_write_wav(tmp_path / "s.wav", 1., 16_000))
    feature = audio.Wav2VecTransformer(Frequency(120.), layers=(1,),
                                       random=True)
    seen = []
    feature.model.register_forward_pre_hook(lambda module, args: seen.append(
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         audio._FORWARD_LOCK.locked())))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    threads = [threading.Thread(target=feature._compute_hidden_states,
                                args=("hidden_states", path, 0., 1., [1]))
               for _ in range(3)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert seen == [(False, False, True)] * 3
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags


def test_a_cpu_run_places_the_encoder_on_the_cpu(small_configs, tmp_path):
    """``device=cpu`` reaches every split's features (the config's
    ``device`` key places nothing), and the encoder renders the tracks on
    the CPU; a builder given another device places it there."""
    folder = tmp_path / "fake_cache"
    folder.mkdir()
    args = train.parse_overrides([
        'dset.selections=["fake"]', "dset.n_recordings=2",
        'dset.features=["Wav2VecTransformer"]',
        'dset.features_params={"Wav2VecTransformer": {"layers": [1, 2], '
        '"device": "cuda", "random": True}}',
        "dset.condition=1.0", "dset.tmin=-0.2", "dset.tmax=1.0",
        "dset.test_ratio=0.3", "dset.valid_ratio=0.2",
        "dset.min_n_blocks_per_split=1", "num_workers=2", "device=cpu",
        f"cache={folder}"])
    with env.temporary(cache=folder):
        datasets = train.build_datasets(args)
        features = [d.features["Wav2VecTransformer"] for split in datasets
                    for d in split.datasets]
        assert {f.device for f in features} == {torch.device("cpu")}
        first = datasets.train.datasets[0]
        assert first[0].features.shape[0] == 1024
        assert max(np.abs(first[k].features).max() for k in range(5)) > 0
    model = features[0].model
    assert {p.device for p in model.parameters()} == {torch.device("cpu")}
    builder = FeaturesBuilder(fake.make_fake_events(total_duration=10),
                              ["Wav2VecTransformer"], PARAMS,
                              Frequency(120.), device="cuda:1")
    assert builder["Wav2VecTransformer"].device == torch.device("cuda:1")
