"""The rest of the JAX package's model zoo in the port, against the flax
modules on the same numpy inputs and bridged weights
(``convert.load_jax_params``): SimpleConv's per-subject merger heads, its
DualPathRNN, its spectrogram branch with the strided head (``n_fft``,
with ``linear_out`` and ``complex_out``, ``fft_complex`` on and off), a
SimpleConv without a MEG input, a strided DeepMel, and three Adam steps
of ``Trainer`` for each SimpleConv option against the JAX solver's step.

Tolerances: forwards rtol = atol 1e-4 (tests/test_torch_serve.py's), the
DualPathRNN 1e-4 of its output's largest magnitude
(tests/test_torch_convrnn.py's FORWARD_TOL), the train steps
tests/test_torch_train.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args
from test_torch_convrnn import _close
from test_torch_train import STEPS, _batches, _leaf, _noise_driven, _trainer

from brainmagick_tpu import train as jtrain
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.models import common as jcommon
from brainmagick_tpu.models.features import DeepMel as JaxDeepMel
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu_torch import convert
from brainmagick_tpu_torch.models import common
from brainmagick_tpu_torch.models.features import DeepMel
from brainmagick_tpu_torch.models.simpleconv import SimpleConv

INVALID = common.INVALID_POSITION
#: a small SimpleConv, as tests/test_torch_models.py's
TINY = dict(hidden={"meg": 24}, depth=2, kernel_size=3, dilation_period=2,
            skip=True, glu=2, glu_context=1, merger=True, merger_channels=16,
            merger_pos_dim=32, initial_linear=16, gelu=True,
            batch_norm=True, subject_layers=True, subject_dim=0,
            complex_out=True)
N_SUBJECTS = 3
FORWARD_RTOL = FORWARD_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomized_stats(stats, seed):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "mean":
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(stats))


def _inputs(channels=20, length=40, seed=5):
    """Seeded MEG [3, C, T], two recordings' positions (recording 1's
    last sensors have none), the samples' recordings and subjects."""
    rng = np.random.RandomState(seed)
    meg = rng.randn(3, channels, length).astype(np.float32)
    rec_positions = rng.rand(2, channels, 2).astype(np.float32)
    rec_positions[1, channels - 5:] = INVALID
    rec_index = np.array([0, 1, 1])
    subjects = np.array([2, 0, 1], np.int32)
    return meg, rec_positions, rec_index, subjects


def _pair(in_channels=None, **overrides):
    """The flax SimpleConv and the port's on its initial weights, with
    seeded BatchNorm running statistics."""
    kw = dict(in_channels=in_channels or {"meg": 20}, out_channels=8,
              n_subjects=N_SUBJECTS, **{**TINY, **overrides})
    if "hidden" not in overrides:
        kw["hidden"] = {name: 24 for name in kw["in_channels"]}
    jmodel, port = JaxSimpleConv(**kw), SimpleConv(**kw).eval()
    inputs = _model_inputs(kw["in_channels"])
    meg, rec_positions, rec_index, subjects = _inputs()
    variables = jmodel.init(jax.random.PRNGKey(0), inputs,
                            jnp.asarray(subjects),
                            jnp.asarray(rec_positions[rec_index]))
    params = {"model": jax.device_get(variables["params"])}
    stats = {"model": _randomized_stats(variables.get("batch_stats", {}), 1)}
    convert.load_jax_params(port, params, stats)
    return jmodel, port, {"params": params["model"],
                          "batch_stats": stats["model"]}


def _model_inputs(in_channels):
    meg = _inputs()[0]
    rng = np.random.RandomState(6)
    return {name: jnp.asarray(meg if name == "meg" else rng.randn(
        3, width, meg.shape[-1]).astype(np.float32))
        for name, width in in_channels.items()}


def _forward_pair(jmodel, port, variables, in_channels=None, jkw=None,
                  kw=None):
    inputs = _model_inputs(in_channels or {"meg": 20})
    _, rec_positions, rec_index, subjects = _inputs()
    positions = rec_positions[rec_index]
    want = jmodel.apply(variables, inputs, jnp.asarray(subjects),
                        jnp.asarray(positions), **(jkw or {}))
    with torch.no_grad():
        got = port({k: _t(v) for k, v in inputs.items()},
                   _t(subjects).long(), _t(positions), **(kw or {}))
    return got.numpy(), np.asarray(want)


# -- the per-subject merger ------------------------------------------------


@pytest.mark.parametrize("given_emb", [False, True],
                         ids=["fourier_in_call", "per_sample_pos_emb"])
def test_per_subject_merger_matches_jax(given_emb):
    """``ChannelMerger(per_subject=True)`` in eval mode: heads [S, O, D]
    gathered by each sample's subject, the per-sample embedding computed
    in the call or given (the per-recording arrays are not read, as in
    flax): atol 1e-5."""
    meg, rec_positions, rec_index, subjects = _inputs(channels=12)
    positions = rec_positions[rec_index]
    jm = jcommon.ChannelMerger(8, pos_dim=32, n_subjects=N_SUBJECTS,
                               per_subject=True)
    meg_btc = jnp.asarray(np.swapaxes(meg, 1, 2))
    variables = jm.init(jax.random.PRNGKey(2), meg_btc,
                        jnp.asarray(positions), jnp.asarray(subjects))
    port = common.ChannelMerger(8, pos_dim=32, n_subjects=N_SUBJECTS,
                                per_subject=True)
    assert port.heads.shape == (N_SUBJECTS, 8, 32)
    convert.load_by_rules(port, [("heads", ("heads",), "copy", "params")],
                          jax.device_get(variables["params"]), {})
    jkw, kw = {}, {}
    if given_emb:
        emb = jcommon.fourier_emb(jnp.asarray(positions), 32)
        jkw = dict(pos_emb=emb)
        # the per-recording arguments are ignored with per-subject heads
        kw = dict(pos_emb=_t(emb), rec_index=_t(rec_index),
                  rec_positions=_t(rec_positions))
    want = jm.apply(variables, meg_btc, jnp.asarray(positions),
                    jnp.asarray(subjects), **jkw)
    got = port(_t(meg), _t(positions), subjects=_t(subjects).long(), **kw)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.swapaxes(np.asarray(want), 1, 2),
                               atol=1e-5)
    with pytest.raises(ValueError, match="subjects"):
        port(_t(meg), _t(positions))


def test_per_subject_merger_dropout_matches_jax(monkeypatch):
    """Train mode: the disk centre flax drew, passed to the port, gives
    the same output (atol 1e-5) and the same usage penalty."""
    drawn = []
    uniform = jax.random.uniform

    def record(*args, **kwargs):
        out = uniform(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out
    monkeypatch.setattr(jax.random, "uniform", record)
    meg, rec_positions, rec_index, subjects = _inputs(channels=12)
    positions = rec_positions[rec_index]
    jm = jcommon.ChannelMerger(8, pos_dim=32, dropout=0.3,
                               usage_penalty=0.5, n_subjects=N_SUBJECTS,
                               per_subject=True)
    meg_btc = jnp.asarray(np.swapaxes(meg, 1, 2))
    args = (meg_btc, jnp.asarray(positions), jnp.asarray(subjects))
    variables = jm.init(jax.random.PRNGKey(3), *args)
    drawn.clear()
    want, sown = jm.apply(variables, *args, train=True,
                          rngs={"dropout": jax.random.PRNGKey(4)},
                          mutable=["losses"])
    (center,) = drawn
    port = common.ChannelMerger(8, pos_dim=32, dropout=0.3,
                                usage_penalty=0.5, n_subjects=N_SUBJECTS,
                                per_subject=True).train()
    convert.load_by_rules(port, [("heads", ("heads",), "copy", "params")],
                          jax.device_get(variables["params"]), {})
    weights = port.attention(_t(positions), center=_t(center),
                             dtype=torch.float32,
                             subjects=_t(subjects).long())
    got = torch.einsum("bct,boc->bot", _t(meg), weights)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.swapaxes(np.asarray(want), 1, 2),
                               atol=1e-5)
    np.testing.assert_allclose(
        port.penalty(weights).item(),
        float(jax.tree_util.tree_leaves(sown)[0]), rtol=1e-6)


@pytest.mark.parametrize("per_recording_args", [False, True],
                         ids=["per_sample", "solver_arrays"])
def test_per_subject_simpleconv_matches_jax(per_recording_args):
    """SimpleConv with ``merger_per_subject``, bridged: rtol = atol 1e-4.
    With the solver's per-sample embedding the fused head stays off, as
    in flax, even when ``fused_head`` asks for it."""
    jmodel, port, variables = _pair(merger_per_subject=True,
                                    fused_head=True)
    calls = []
    port._fused_head = lambda *a, **k: calls.append(1)
    jkw = kw = {}
    if per_recording_args:
        meg, rec_positions, rec_index, subjects = _inputs()
        emb = jcommon.fourier_emb(jnp.asarray(rec_positions[rec_index]), 32)
        jkw = dict(pos_emb=emb)
        kw = dict(pos_emb=_t(emb), rec_index=_t(rec_index),
                  rec_positions=_t(rec_positions),
                  rec_subjects=torch.tensor([2, 0]))
    got, want = _forward_pair(jmodel, port, variables, jkw=jkw, kw=kw)
    assert got.shape == (3, 8, 40) and not calls
    np.testing.assert_allclose(got, want, rtol=FORWARD_RTOL,
                               atol=FORWARD_ATOL)


# -- DualPathRNN ---------------------------------------------------------


@pytest.mark.parametrize("depth,length,dtype", [
    (1, 23, np.float32), (2, 30, np.float32), (1, 17, jnp.bfloat16)],
    ids=["depth1_ragged", "depth2_whole_chunks", "bf16_input"])
def test_dual_path_rnn_matches_jax(depth, length, dtype):
    """flax's DualPathRNN on bridged LSTM weights (moved off their
    initialization): the intra- and inter-chunk LSTMs, residuals, flips
    and the right padding cut at the end, FORWARD_TOL. A bf16 input meets
    the fp32 LSTMs in fp32 and comes out fp32, as in flax."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, length, 6).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    jm = jcommon.DualPathRNN(6, depth)
    variables = jm.init(jax.random.PRNGKey(0), xj)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.2 * rng.randn(*v.shape)).astype(
            np.float32), jax.device_get(variables["params"]))
    want = jm.apply({"params": params}, xj)
    port = common.DualPathRNN(6, depth)
    assert len(port.lstms) == 4 * depth
    rules = [r for i, lstm in enumerate(port.lstms)
             for r in convert.stacked_lstm_rules(lstm, f"lstms.{i}.", (),
                                                 first=i)]
    convert.load_by_rules(port, rules, params, {})
    xt = _t(x).to(torch.bfloat16 if dtype is jnp.bfloat16 else
                  torch.float32).transpose(1, 2)
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got.transpose(1, 2).numpy(), np.asarray(want))


def test_dual_path_simpleconv_matches_jax():
    """SimpleConv with ``dual_path=1`` after the encoder, bridged (the
    LSTMs read flax's DualPathRNN_0/OptimizedLSTMCell_{i}): rtol = atol
    1e-4; the port's rules name every leaf of flax's tree."""
    jmodel, port, variables = _pair(dual_path=1)
    assert ("DualPathRNN_0" in variables["params"]
            and len(port.dual_path_rnn.lstms) == 4)
    got, want = _forward_pair(jmodel, port, variables)
    np.testing.assert_allclose(got, want, rtol=FORWARD_RTOL,
                               atol=FORWARD_ATOL)


# -- the spectrogram branch ----------------------------------------------


@pytest.mark.parametrize("fft_complex", [True, False],
                         ids=["complex", "modulus"])
@pytest.mark.parametrize("length", [40, 37], ids=["T40", "T37"])
def test_stft_matches_jax(fft_complex, length):
    """``SimpleConv._stft`` against the flax module's ``_stft`` on the
    same [B, C, T] (the flax one reads [B, T, C]): the frames, the
    channel order (sensor, bin, part) and the values, atol 1e-5."""
    rng = np.random.RandomState(8)
    meg = rng.randn(2, 5, length).astype(np.float32)
    jmodel = JaxSimpleConv(in_channels={"meg": 5}, out_channels=4,
                           hidden={"meg": 8}, n_fft=8,
                           fft_complex=fft_complex, linear_out=True)
    want = np.asarray(jmodel._stft(jnp.asarray(np.swapaxes(meg, 1, 2))))
    port = SimpleConv(in_channels={"meg": 5}, out_channels=4,
                      hidden={"meg": 8}, n_fft=8, fft_complex=fft_complex,
                      linear_out=True)
    got = port._stft(_t(meg)).numpy()
    assert got.shape == (2, want.shape[2], want.shape[1])
    np.testing.assert_allclose(got, np.swapaxes(want, 1, 2), atol=1e-5)


@pytest.mark.parametrize("head", [dict(linear_out=True, complex_out=False),
                                  dict()], ids=["linear_out", "complex_out"])
@pytest.mark.parametrize("fft_complex", [True, False],
                         ids=["complex", "modulus"])
def test_stft_simpleconv_matches_jax(head, fft_complex):
    """SimpleConv with ``n_fft=8``: the spectrogram of the subject
    layers' output, the encoder over its frames, and the strided head
    (flax's ConvTranspose(kernel 8, stride 4, padding (2, 2)), after
    ``complex_out``'s 1x1 conv and activation), cropped to the input's
    length, bridged: rtol = atol 1e-4. Also with the subject embedding,
    which is concatenated over the frames."""
    for extra in (dict(), dict(subject_dim=4)):
        jmodel, port, variables = _pair(n_fft=8, fft_complex=fft_complex,
                                        **head, **extra)
        final = port.final if head else port.final[2]
        assert (final.kernel_size, final.stride) == ((8,), (4,))
        got, want = _forward_pair(jmodel, port, variables)
        assert got.shape == (3, 8, 40)
        np.testing.assert_allclose(got, want, rtol=FORWARD_RTOL,
                                   atol=FORWARD_ATOL)


def test_stft_needs_a_head():
    with pytest.raises(ValueError, match="n_fft"):
        SimpleConv(in_channels={"meg": 5}, out_channels=4,
                   hidden={"meg": 8}, n_fft=8)


# -- a SimpleConv without a MEG input --------------------------------------


@pytest.mark.parametrize("overrides", [
    dict(), dict(linear_out=True, complex_out=False, subject_dim=4)],
    ids=["complex_out", "linear_out"])
def test_simpleconv_without_meg_matches_jax(overrides):
    """in_channels without 'meg': no merger, initial conv, subject layers
    or embedding is built (flax builds them only for a MEG input), and the
    features' encoder and the head run: rtol = atol 1e-4."""
    channels = {"features": 6}
    jmodel, port, variables = _pair(in_channels=channels, **overrides)
    assert port.merger is None and port.subject_layers is None
    assert set(variables["params"]) == {"encoder_features",
                                        "Conv_0", "ConvTranspose_0"} \
        or set(variables["params"]) == {"encoder_features",
                                        "ConvTranspose_0"}
    got, want = _forward_pair(jmodel, port, variables, channels)
    assert got.shape == (3, 8, 40)
    np.testing.assert_allclose(got, want, rtol=FORWARD_RTOL,
                               atol=FORWARD_ATOL)


# -- the bridge of the new leaves ----------------------------------------


@pytest.mark.parametrize("overrides", [
    dict(dual_path=2), dict(n_fft=8), dict(n_fft=4, linear_out=True,
                                           complex_out=False),
    dict(merger_per_subject=True, dual_path=1, n_fft=8, subject_dim=4)],
    ids=str)
def test_new_rules_name_the_flax_tree(overrides):
    """For the options the JAX package's rules refuse (DualPathRNN, the
    spectrogram head) or that change a leaf's shape (the per-subject
    heads), the port's rules name exactly flax's leaves, each of the
    shape the port's weight takes after its transform, and exactly the
    port's weights."""
    jmodel, port, variables = _pair(**overrides)
    shapes = {("model",) + tuple(p.key for p in path): leaf.shape
              for coll in ("params", "batch_stats")
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  variables[coll])}
    rules = convert.simpleconv_rules(port)
    assert {r[1] for r in rules} == set(shapes)
    state = port.state_dict()
    assert {r[0] for r in rules} == {
        k for k in state if not k.endswith("num_batches_tracked")}
    for tkey, fpath, kind, _ in rules:
        value = convert._untransform(kind, np.zeros(shapes[fpath]))
        assert value.shape == tuple(state[tkey].shape), tkey


# -- DeepMel's stride ----------------------------------------------------


@pytest.mark.parametrize("stride", [2, 3])
def test_strided_deepmel_matches_jax(stride):
    """A strided DeepMel (unfused strided convs, no skip where the length
    shrinks, GLU convs unstrided): eval and train mode against flax on
    the same weights, the outputs and the running statistics atol 1e-5;
    the output is T / stride per layer long."""
    kw = dict(n_hidden_channels=16, n_hidden_layers=3, n_out_channels=24,
              stride=stride)
    x = np.random.RandomState(0).randn(4, 8, 41).astype(np.float32)
    jfm = JaxDeepMel(n_in_channels=8, **kw)
    variables = jax.device_get(jfm.init(jax.random.PRNGKey(0), x))
    variables["batch_stats"] = _randomized_stats(variables["batch_stats"], 1)
    port = DeepMel(n_in_channels=8, **kw)
    assert port.stride == stride and not any(port.fused)
    convert.load_by_rules(port, convert.deepmel_rules(port),
                          {"fm": variables["params"]},
                          {"fm": variables["batch_stats"]})
    want = np.asarray(jfm.apply(variables, x, train=False))
    got = port.eval()(_t(x)).detach().numpy()
    assert got.shape == want.shape and want.shape[-1] < 41
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want, mutated = jfm.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    got = port.train()(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    stats = jax.device_get(mutated["batch_stats"])
    for tkey, fpath, _, coll in convert.deepmel_rules(port):
        if coll == "batch_stats":
            np.testing.assert_allclose(port.get_buffer(tkey).numpy(),
                                       _leaf(stats, fpath[1:]), rtol=0,
                                       atol=1e-5, err_msg=tkey)


def test_strided_deepmel_fails_where_jax_does(tmp_path):
    """The JAX solver with a strided DeepMel builds and then fails its
    first train step with a ValueError (the loss contracts the estimate
    with shorter targets); the port's Trainer on its weights builds too
    and fails the same step with a ValueError that names the stride."""
    cache = tmp_path / "fake_cache"
    cache.mkdir()
    cell = ["preset=deep_mel", "simpleconv.merger_dropout=0.0",
            "feature_model_params.n_hidden_channels=16",
            "feature_model_params.n_hidden_layers=2",
            "feature_model_params.n_out_channels=24",
            "feature_model_params.stride=2"]
    args = jtrain.parse_overrides(cell, tiny_args(cache, tmp_path))
    with jenv.temporary(cache=cache):
        solver = jtrain.get_solver(args, training=True)
        batch = _batches(solver)[0]
        step = solver._build_step(True, False, False)
        with pytest.raises(ValueError):
            step(solver.state, batch.to_device(), solver.norm_arrays,
                 jnp.ones(len(batch), jnp.float32), None, None,
                 jax.random.PRNGKey(0))
        state = jax.device_get(solver.state)
        from brainmagick_tpu_torch import train
        trainer = train.Trainer(
            solver.args, solver.model.in_channels["meg"],
            solver.feature_model.n_in_channels, solver.model.n_subjects,
            state["params"], state["batch_stats"],
            {k: np.asarray(v) for k, v in solver.norm_arrays.items()},
            device="cpu", generator=torch.Generator().manual_seed(0))
    assert trainer.feature_model.stride == 2
    with pytest.raises(ValueError, match="stride=2"):
        trainer.step(batch)


# -- three Adam steps of each option against the JAX solver ---------------


#: the SimpleConv options, each on tests/test_solver.py's tiny_args without
#: merger dropout
OPTIONS = {"merger_per_subject": dict(merger_per_subject=True),
           "dual_path": dict(dual_path=1),
           "n_fft": dict(n_fft=4)}


@pytest.fixture(scope="module")
def option_solvers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo")
    cache = tmp / "fake_cache"
    cache.mkdir()
    solvers = {}
    with jenv.temporary(cache=cache):
        for name, options in OPTIONS.items():
            args = tiny_args(cache, tmp / name)
            args.simpleconv.update(merger_dropout=0., **options)
            solvers[name] = jtrain.get_solver(args, training=True)
        yield solvers


def _noise(model, tkey):
    """``test_torch_train._noise_driven``, with per-subject heads: their
    column 0 (the constant Fourier feature) of every subject."""
    if tkey == "merger.heads" and model.merger.per_subject:
        mask = np.zeros(model.merger.heads.shape, bool)
        mask[..., 0] = True
        return mask
    return _noise_driven(model, tkey)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_train_steps_match_jax_solver(option_solvers, option):
    """Three Trainer.steps against the JAX solver's jitted step on the
    same batches and weights, as tests/test_torch_train.py's
    ``test_train_steps_match_jax_solver``: the losses rtol 1e-5, keep and
    count exactly, the first step's gradients atol 1e-5, the parameters
    within 0.01 lr (the noise-driven entries within 2 lr a step), the
    running variances rtol 1e-5 and the running means within the share of
    the noise-driven biases' drift they take in."""
    solver = option_solvers[option]
    trainer = _trainer(solver)
    model = trainer.model
    assert (model.merger.per_subject, model.dual_path, model.n_fft) == (
        option == "merger_per_subject", int(option == "dual_path"),
        4 if option == "n_fft" else None)
    step = solver._build_step(True, False, False)
    state = jax.tree_util.tree_map(jnp.array, solver.state)
    rng = jax.random.PRNGKey(0)
    rules = convert.simpleconv_rules(model)
    for i, batch in enumerate(_batches(solver)):
        arrays = batch.to_device()
        pad = jnp.ones(len(batch), jnp.float32)
        if i == 0:
            grads = jax.device_get(jax.grad(lambda p: solver._loss_and_aux(
                p, state["batch_stats"], arrays, solver.norm_arrays, pad,
                None, None, rng, True, False)[0])(state["params"]))
        state, want = step(state, arrays, solver.norm_arrays, pad, None,
                           None, rng)
        got = trainer.step(batch)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-5)
        assert got["keep"].item() == float(want["keep"])
        assert got["count"].item() == float(want["count"]) == len(batch)
        if i == 0:
            for tkey, fpath, kind, coll in rules:
                if coll == "params":
                    np.testing.assert_allclose(
                        model.get_parameter(tkey).grad.numpy(),
                        convert._untransform(kind, _leaf(grads, fpath)),
                        rtol=0, atol=1e-5, err_msg=tkey)
    lr = solver.args.optim.lr
    state = jax.device_get(state)
    for tkey, fpath, kind, coll in rules:
        want = convert._untransform(kind, _leaf(state[coll], fpath))
        if coll == "params":
            got = model.get_parameter(tkey).detach().numpy()
            atol = np.where(_noise(model, tkey), 2 * STEPS * lr, 0.01 * lr)
            assert (np.abs(got - want) <= atol).all(), tkey
        elif tkey.endswith("running_var"):
            np.testing.assert_allclose(model.get_buffer(tkey).numpy(), want,
                                       rtol=1e-5, err_msg=tkey)
        else:
            np.testing.assert_allclose(
                model.get_buffer(tkey).numpy(), want, rtol=0,
                atol=2 * STEPS * lr * (1 - 0.99 ** STEPS), err_msg=tkey)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_eval_step_matches_jax_solver(option_solvers, option):
    """train=False: the eval-mode loss (rtol 1e-5), as
    ``test_eval_step_matches_jax_solver``."""
    solver = option_solvers[option]
    trainer = _trainer(solver)
    batch = _batches(solver)[0]
    _, want = solver._build_step(False, False, False)(
        solver.state, batch.to_device(), solver.norm_arrays,
        jnp.ones(len(batch), jnp.float32), None, None,
        jax.random.PRNGKey(0))
    got = trainer.step(batch, train=False)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
