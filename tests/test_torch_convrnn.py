"""The PyTorch port's ConvRNN against the JAX package's flax modules on the
same numpy inputs and bridged weights: the stacked LSTM (one and two
directions), local attention (eval and train BatchNorm), the strided and
transposed ConvSequence, the whole model's forward at a ragged length
under each structural option, its valid length, and its seeded
initialization.

Tolerances: forwards 1e-4 relative to the output's largest magnitude
(tests/test_torch_serve.py's), running statistics 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainmagick_tpu import convert as jconvert
from brainmagick_tpu.models import common as jcommon
from brainmagick_tpu.models import convrnn as jconvrnn
from brainmagick_tpu_torch import convert
from brainmagick_tpu_torch.models import common, convrnn

#: forward outputs: max |port - JAX| over max |JAX|
FORWARD_TOL = 1e-4
#: a ragged length: the encoders see valid_length(47) = 50 samples
T = 47


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max() / scale
    assert err <= FORWARD_TOL, (what, err)


def _randomized(variables, rng):
    """Flax's initial parameters moved off their initialization (every
    leaf plus 0.1 N(0, 1): biases and running means away from 0), and
    running variances drawn in [0.5, 1.5], so that no ReLU is dead."""
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.randn(*x.shape)).astype(
            np.float32), jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 1.5, x.shape) if path[-1].key
                         == "var" else 0.1 * rng.randn(*x.shape)).astype(
                             np.float32),
        jax.device_get(variables.get("batch_stats", {})))
    return params, stats


def _jit_apply(module):
    """The module's apply, jitted: one compile is quicker on the CPU than
    the op-by-op dispatch of an unjitted apply."""
    return jax.jit(module.apply, static_argnames=("train", "mutable"))


def _flax_variables(port, rules, shapes, seed):
    """Flax variables made from the port's seeded initialization through
    the port's `rules` run backwards (the JAX package's ``_transform``;
    a Dense kernel is the transposed weight). Their leaves and shapes must
    be the flax module's (`shapes`, ``jax.eval_shape`` of its init, which
    compiles nothing: flax's own init compiles its orthogonal and
    truncated-normal draws for seconds a shape)."""
    port.reset_parameters(torch.Generator().manual_seed(seed))
    state = port.state_dict()
    variables: dict = {}
    for tkey, fpath, kind, coll in rules:
        value = state[tkey].numpy()
        value = value.T if kind == "dense_w" else jconvert._transform(
            kind, value)
        node = variables.setdefault(coll, {})
        for part in fpath[:-1]:
            node = node.setdefault(part, {})
        node[fpath[-1]] = np.ascontiguousarray(value)
    got = jax.tree_util.tree_map(np.shape, variables)
    want = jax.tree_util.tree_map(lambda x: x.shape, jax.device_get(shapes))
    assert got == want
    return variables


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["forward", "bidirectional"])
def test_stacked_lstm_matches_flax(bidirectional):
    """Two layers of flax's OptimizedLSTMCell scanned over time (and, two
    ways, each layer's backward cell and the Dense back to H) against the
    port's one torch.lstm call, on [B, T, C] inputs; its gradient in the
    input against jax.grad's too. The port's stack trains one bias per
    gate, as flax's cells do: no parameter of it is a second bias."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, T, 5).astype(np.float32)
    jm = jconvrnn.StackedLSTM(6, 2, bidirectional)
    port = convrnn.StackedLSTM(5, 6, 2, bidirectional)
    rules = convert.stacked_lstm_rules(port, "", ())
    variables = _flax_variables(port, rules, jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    params, _ = _randomized(variables, rng)
    convert.load_by_rules(port, rules, params, {})
    assert len(port.cells) == (4 if bidirectional else 2)
    assert all(name.split(".")[-2] in ("input", "hidden", "bias")
               or name.startswith("linear.")
               for name, _ in port.named_parameters())

    def jfn(inp):
        return jm.apply({"params": params}, inp)
    want = jax.jit(jfn)(jnp.asarray(x))
    want_grad = jax.jit(jax.grad(lambda inp: jfn(inp).sum()))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = port(xt)
    got.sum().backward()
    _close(got.detach().numpy(), want, "output")
    _close(xt.grad.numpy(), want_grad, "input gradient")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_local_attention_matches_flax(train):
    """The ±radius mask, the relative-position table, the 0.3 terms, the
    1x1 convs, BatchNorm (running statistics in eval; batch statistics in
    train, which move the running ones as flax's do), ReLU and the learned
    scale, at a length past the window (T=120 > 2 x radius)."""
    rng = np.random.RandomState(1)
    length = 120
    x = rng.randn(2, length, 8).astype(np.float32)
    jm = jconvrnn.LocalAttention(8, heads=2)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    params, stats = _randomized(variables, rng)
    port = convrnn.LocalAttention(8, heads=2).train(train)
    convert.load_by_rules(port, convert.local_attention_rules(
        "", ()), params, stats)
    want, mutated = _jit_apply(jm)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=train, mutable=("batch_stats",))
    got = port(_t(np.swapaxes(x, 1, 2)))
    _close(got.detach().numpy(), np.swapaxes(np.asarray(want), 1, 2))
    bn = mutated["batch_stats"]["BatchNorm_0"]
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port.bn, name).numpy(),
                                   np.asarray(bn[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("decode", [False, True], ids=["encode", "decode"])
def test_strided_conv_sequence_matches_flax(decode):
    """ConvSequence at kernel 4 and stride 2 with BatchNorm, in train mode:
    the encoder's strided convs pad 2 a side as flax's nn.Conv does, and
    the decoder's transposed convs give flax's 2T samples, not bm's
    2T - 2 (torch's ConvTranspose1d(padding=2) would give 2T - 2, the
    same samples shifted by one)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, T, 6).astype(np.float32)
    kw = dict(kernel=4, stride=2, batch_norm=True, decode=decode)
    jm = jcommon.ConvSequence((6, 7, 5), **kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    params, stats = _randomized(variables, rng)
    port = common.ConvSequence((6, 7, 5), **kw).train()
    convert.load_by_rules(port, convert.conv_sequence_rules(port, "", ()),
                          params, stats)
    want, _ = _jit_apply(jm)({"params": params, "batch_stats": stats},
                             jnp.asarray(x), train=True,
                             mutable=("batch_stats",))
    got = port(_t(np.swapaxes(x, 1, 2)))
    assert got.shape[-1] == (4 * T if decode else 13)
    _close(got.detach().numpy(), np.swapaxes(np.asarray(want), 1, 2))
    assert not any(port.fused)


#: small widths: the MEG 5 channels at hidden 8, the features 3 at 4
BASE = dict(in_channels=dict(meg=5, features=3), out_channels=5,
            hidden=dict(meg=8, features=4), n_subjects=3, subject_dim=4,
            lstm=2, batch_norm=True)
#: the structural options, each case beside the base (the convrnn
#: preset's structure): the residual attention with a bidirectional LSTM
#: over reversed time and the complex head at growth 2; one concatenated
#: branch with subject layers, the embedding at the input and the LSTM,
#: and the linear head; the decode task's single MEG branch with
#: subject layers to the hidden width, the embedding at the input only and
#: no LSTM
OPTIONS = {"base": {},
           "attention_bidirectional_flip_complex_growth": dict(
               attention=1, bidirectional_lstm=True, flip_lstm=True,
               complex_out=True, growth=2.),
           "concatenate_subject_layers_input_lstm_linear": dict(
               concatenate=True, subject_layers=True,
               embedding_location=("input", "lstm"), linear_out=True),
           "decode_hidden_subject_layers_input_no_lstm": dict(
               in_channels=dict(meg=5), hidden=dict(meg=8), out_channels=2,
               subject_layers=True, subject_layers_dim="hidden",
               embedding_location=("input",), lstm=0)}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_convrnn_forward_matches_flax(option):
    """The whole model at the ragged T=47, in eval mode (running
    statistics) and train mode (batch statistics), from a flax tree
    through convert.load_jax_params (every leaf consumed): padding to
    valid_length, the encoders, the subject layers and embedding, the
    LSTM, attention, the decoder's flax padding (2T a layer; bm's 2T - 2
    would shift every sample) and the head, then the first T samples."""
    kw = {**BASE, **OPTIONS[option]}
    rng = np.random.RandomState(3)
    inputs = {name: rng.randn(3, c, T).astype(np.float32)
              for name, c in kw["in_channels"].items()}
    subjects = np.array([0, 2, 1], np.int32)
    jm, port = jconvrnn.ConvRNN(**kw), convrnn.ConvRNN(**kw)
    jinputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3), jinputs,
                            jnp.asarray(subjects))
    variables = _flax_variables(
        convrnn.ConvRNN(**kw), convert.convrnn_rules(port),
        {coll: {"model": tree} for coll, tree in shapes.items()}, 3)
    params, stats = _randomized({coll: tree["model"] for coll, tree
                                 in variables.items()}, rng)
    convert.load_jax_params(port, {"model": params}, {"model": stats})
    assert port.valid_length(T) == jm.valid_length(T)
    for train in (False, True):
        want = _jit_apply(jm)(
            {"params": params, "batch_stats": stats}, jinputs,
            jnp.asarray(subjects), train=train,
            mutable=("batch_stats",) if train else False)
        want = want[0] if train else want
        got = port.train(train)({k: _t(v) for k, v in inputs.items()},
                                _t(subjects).long())
        assert got.shape == (3, kw["out_channels"], T)
        _close(got.detach().numpy(), want, f"train={train}")


def test_convrnn_valid_length_and_refusals():
    """valid_length equals the flax module's over lengths, depths and
    strides; options the port refuses raise at the call that needs them;
    lstm_dropout is accepted and read by nothing, as in JAX."""
    for depth in (1, 2, 3):
        for stride in (1, 2, 3):
            kw = {**BASE, "depth": depth, "stride": stride}
            jm, port = jconvrnn.ConvRNN(**kw), convrnn.ConvRNN(**kw)
            for length in (1, 2, 47, 120, 361):
                assert port.valid_length(length) == jm.valid_length(length)
                assert port.valid_length(length) >= length
    assert convrnn.ConvRNN(**BASE).valid_length(361) == 362
    with pytest.raises(ValueError, match="exclusive"):
        convrnn.ConvRNN(**{**BASE, "linear_out": True, "complex_out": True})
    with pytest.raises(ValueError, match="keys"):
        convrnn.ConvRNN(**{**BASE, "hidden": dict(meg=8)})
    model = convrnn.ConvRNN(**{**BASE, "conv_dropout": 0.1,
                               "lstm_dropout": 0.3})
    model.reset_parameters(torch.Generator().manual_seed(0))
    inputs = {"meg": torch.zeros(2, 5, T), "features": torch.zeros(2, 3, T)}
    assert model.eval()(inputs, torch.zeros(2, dtype=torch.long)).shape \
        == (2, 5, T)
    # train mode's dropout masks need an explicit generator (or masks)
    with pytest.raises(ValueError, match="generator"):
        model.train()(inputs, torch.zeros(2, dtype=torch.long))
    out = model.train()(inputs, torch.zeros(2, dtype=torch.long),
                        generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 5, T) and torch.isfinite(out).all()


def test_convrnn_seeded_initialization():
    """reset_parameters draws from the explicit generator only: the same
    seed gives the same weights whatever torch's global seed, another
    seed others; the recurrent
    kernels are orthogonal, the biases zero, the attention scale 0.1 and
    the subject table N(0, 1/scale^2)."""
    kw = {**BASE, "attention": 1, "bidirectional_lstm": True,
          "embedding_scale": 10.}
    models = []
    for seed in (5, 5, 6):
        model = convrnn.ConvRNN(**kw)
        torch.manual_seed(len(models))  # the global generator is not read
        model.reset_parameters(torch.Generator().manual_seed(seed))
        models.append(model.state_dict())
    a, b, c = models
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lstm.cells.0.input.i"],
                           c["lstm.cells.0.input.i"])
    w = a["lstm.cells.1.hidden.g"]
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(len(w)),
                               atol=1e-5)
    assert all(not a[k].any() for k in a if ".bias." in k)
    assert torch.equal(a["attentions.0.scale"], torch.full((12,), 0.1))
    assert float(a["subject_embedding.embedding.weight"].std()) < 0.3



def test_batch_norm_keeps_float64():
    """BatchNorm computes in fp32 on fp32 and bf16 input and in float64 on
    float64 input (the float64 step chip_smoke.py holds against the
    card): on a channel 1000 standard deviations from 0, float64's
    normalization matches the exact one to 1e-9, where fp32's is 1e-3
    off."""
    rng = np.random.RandomState(5)
    x = _t(rng.randn(4, 3, 50))
    x[:, 1] += 1000.
    mean = x.mean(dim=(0, 2), keepdim=True)
    exact = (x - mean) / torch.sqrt(
        ((x - mean) ** 2).mean(dim=(0, 2), keepdim=True) + 1e-5)
    for dtype, bound in ((torch.float64, 1e-9), (torch.float32, None)):
        bn = common.BatchNorm(3).to(dtype).train()
        with torch.no_grad():
            out = bn(x.to(dtype))
        assert out.dtype == dtype
        err = float((out.double() - exact).abs().max())
        assert err <= bound if bound else err > 1e-3, (dtype, err)
    assert common.BatchNorm(3).train()(x.to(torch.bfloat16)).dtype \
        == torch.bfloat16
