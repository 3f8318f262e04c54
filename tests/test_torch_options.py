"""The train step's model options in the PyTorch port against the JAX
package on the same numpy inputs and bridged weights: dropouts on an
explicit generator (flax's draws, made by a seeded stand-in for
``jax.random.bernoulli`` and ``jax.random.uniform``, recorded and
replayed), ChannelDropout in train and
eval mode, SimpleConv's rewrite, LayerScale and post-skip convs, its
``output_layout="btc"``, ConvRNN's dropouts, preset ``none``, and which
options construct or still raise. The SVD penalty, the negative pool and
ClipLoss's projection are in tests/test_torch_options_train.py.

Tolerances: a module in fp32 1e-5 of the output's largest magnitude; the
dropout itself in bf16 within tests/test_torch_recipe.py's CAST_TOL, a
bf16 conv stack within its MODULE_TOL and a bf16 model within its
RECIPE_TOL (in norm); a whole SimpleConv in fp32 within the serving
test's rtol = atol = 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from test_torch_convrnn import _flax_variables, _randomized
from test_torch_recipe import (BF16, CAST_TOL, MODULE_TOL, RECIPE_TOL,
                               STRUCTURE, TINY, _bct, _max_err, _norm_err,
                               _np)

from brainmagick_tpu import config as jconfig
from brainmagick_tpu.models import common as jcommon
from brainmagick_tpu.models import convrnn as jconvrnn
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu_torch import config, convert
from brainmagick_tpu_torch.models import common, convrnn
from brainmagick_tpu_torch.models.simpleconv import SimpleConv

INVALID = common.INVALID_POSITION
#: a module in fp32: max |port - JAX| over max |JAX|
MODULE_FP32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture
def draws(monkeypatch):
    """The random draws of flax's train mode, recorded in draw order as
    numpy ({"masks": [...], "centers": [...]}): every
    ``jax.random.bernoulli`` (dropout keep masks) and
    ``jax.random.uniform`` (disk centres) is a seeded numpy draw of the
    shape, probability and type flax asks for, so that a jitted apply
    (traced once) uses the masks recorded here."""
    seen = {"masks": [], "centers": []}
    rng = np.random.RandomState(11)

    def bernoulli(key, p=0.5, shape=None):
        mask = rng.rand(*shape) < p
        seen["masks"].append(mask)
        return jnp.asarray(mask)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0., maxval=1.):
        value = (minval + (maxval - minval) * rng.rand(*shape)).astype(
            np.dtype(dtype))
        seen["centers"].append(value)
        return jnp.asarray(value)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    return seen


def _t(x):
    return torch.from_numpy(np.array(x))


def _centers(draws):
    """flax's disk centres as fp32 tensors (a bf16 centre exactly)."""
    return [_t(np.asarray(c, np.float32)) for c in draws["centers"]]


def _port_masks(masks):
    """flax's [B, T, C] keep masks in the port's [B, C, T]."""
    return [torch.from_numpy(np.swapaxes(m, 1, 2).copy()) for m in masks]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_dropout_matches_flax(draws, dtype):
    """flax's nn.Dropout in train mode against the port's Dropout given
    flax's mask: the kept elements divided by the keep probability in the
    input's type (bf16 rounds there), the others 0; fp32 within 1e-5,
    bf16 within CAST_TOL."""
    x = np.random.RandomState(0).randn(4, 6, 10).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = fnn.Dropout(0.3).apply({}, xj, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
    mask = _t(draws["masks"][-1])
    xt = _t(xj.astype(jnp.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = common.Dropout(0.3).train()(xt, mask=mask)
    assert got.dtype == xt.dtype
    assert 0.5 < mask.float().mean() < 0.9
    tol = CAST_TOL if dtype == jnp.bfloat16 else MODULE_FP32_TOL
    assert _max_err(got, want) <= tol


#: a conv stack with both dropouts, GLU gates and dilation period 2
SEQ = dict(channels=(16, 16, 16, 16), kernel=3, dilation_growth=2,
           dilation_period=2, skip=True, batch_norm=True, glu=2,
           glu_context=1, dropout=0.2, dropout_input=0.3)


def _seq_pair(fused, bf16):
    act = dict(gelu=True, gelu_exact=not bf16)
    jseq = jcommon.ConvSequence(
        stride=1, activation=jcommon.get_activation(**act),
        fused_conv_bn=fused, bn_conv_bias=not bf16,
        dtype=jnp.bfloat16 if bf16 else None, **SEQ)
    port = common.ConvSequence(
        activation=common.get_activation(**act), fused_conv_bn=fused,
        bn_conv_bias=not bf16,
        compute_dtype=torch.bfloat16 if bf16 else None, **SEQ)
    x = np.random.RandomState(0).randn(3, 16, 40).astype(np.float32)
    variables = jax.device_get(jax.jit(jseq.init)(
        jax.random.PRNGKey(0), jnp.asarray(np.swapaxes(x, 1, 2))))
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: ((rng.randn(*v.shape) * 0.1) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    rules = convert.conv_sequence_rules(port, "", ())
    convert.load_by_rules(port, rules, variables["params"], stats)
    return jseq, port, variables["params"], stats, rules, x


@pytest.mark.parametrize("fused, bf16", [(False, False), (True, False),
                                         (False, True), (True, True)],
                         ids=["fp32", "fp32_fused", "bf16", "bf16_fused"])
def test_conv_sequence_dropouts_match_flax(draws, fused, bf16):
    """The conv stack in train mode with the input dropout and the
    layers' dropouts, flax's masks replayed in draw order (fused: the
    input dropout before conv_stats, the layer's after it): the output
    and the running statistics within 1e-5 in fp32; in bf16 the output
    within MODULE_TOL, as tests/test_torch_recipe.py holds this stack
    without dropouts."""
    jseq, port, params, stats, rules, x = _seq_pair(fused, bf16)
    xj = jnp.asarray(np.swapaxes(x, 1, 2))
    xt = torch.from_numpy(x)
    if bf16:
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    draws["masks"].clear()
    want, mutated = jax.jit(lambda v, x: jseq.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(3)}))(
            {"params": params, "batch_stats": stats}, xj)
    # the input dropout, then one after each of the three activations
    assert len(draws["masks"]) == 4
    got = port.train()(xt, masks=_port_masks(draws["masks"]))
    assert _max_err(got, _bct(want)) <= (MODULE_TOL if bf16
                                         else MODULE_FP32_TOL)
    if bf16:
        return
    state = dict(port.named_buffers())
    for tkey, fpath, kind, coll in rules:
        if coll == "batch_stats":
            node = mutated["batch_stats"]
            for part in fpath:
                node = node[part]
            assert _max_err(state[tkey], node) <= MODULE_FP32_TOL, tkey


def test_dropout_generator_rules():
    """The masks come from the explicit generator only: the same seed
    gives the same output, another seed another, torch's global generator
    is not touched; train mode without a generator or masks raises; eval
    mode ignores the dropouts (the stack without them gives the same)."""
    _, port, _, _, _, x = _seq_pair(False, False)
    xt = torch.from_numpy(x)
    port.train()
    state = torch.get_rng_state()
    a, b, c = (port(xt, torch.Generator().manual_seed(seed))
               for seed in (5, 5, 6))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        port(xt)
    plain = common.ConvSequence(
        activation=common.get_activation(gelu=True),
        **{**SEQ, "dropout": 0., "dropout_input": 0.})
    convert.load_by_rules(
        plain, convert.conv_sequence_rules(plain, "", ()), *_trees(port))
    port.eval()
    plain.eval()
    with torch.no_grad():
        assert torch.equal(port(xt), port(xt, torch.Generator()))
        assert torch.equal(port(xt), plain(xt))


def _trees(port):
    """A port ConvSequence's weights as flax trees, through its rules."""
    from brainmagick_tpu.convert import _transform
    trees = {"params": {}, "batch_stats": {}}
    state = port.state_dict()
    for tkey, fpath, kind, coll in convert.conv_sequence_rules(port, "", ()):
        node = trees[coll]
        for part in fpath[:-1]:
            node = node.setdefault(part, {})
        node[fpath[-1]] = _transform(kind, state[tkey].numpy())
    return trees["params"], trees["batch_stats"]


def _positions_case(dtype=np.float32):
    rng = np.random.RandomState(4)
    meg = rng.randn(3, 12, 9).astype(dtype)
    positions = rng.rand(3, 12, 2).astype(np.float32)
    positions[1, 8:] = INVALID
    return meg, positions


@pytest.mark.parametrize("train, bf16", [(False, False), (True, False),
                                         (True, True)],
                         ids=["eval", "train", "train_bf16"])
def test_channel_dropout_matches_flax(draws, train, bf16):
    """ChannelDropout against flax's with the centre it drew (in the
    meg's type): in eval mode the padded sensors zeroed and nothing else
    changed; in train mode the disk's sensors zeroed and each sensor
    divided by its midpoint-rule keep probability (the result fp32, as in
    flax); within 1e-5."""
    meg, positions = _positions_case()
    jd = jcommon.ChannelDropout(0.3, rescale=True)
    mj = jnp.asarray(np.swapaxes(meg, 1, 2))
    mt = _t(meg)
    if bf16:
        mj, mt = mj.astype(jnp.bfloat16), mt.bfloat16()
    want = jd.apply({}, mj, jnp.asarray(positions), train=train,
                    rngs={"dropout": jax.random.PRNGKey(2)})
    port = common.ChannelDropout(0.3).train(train)
    center = None
    if train:
        (center,) = draws["centers"]
        assert center.dtype == mj.dtype
        center = _t(np.asarray(center, np.float32)).to(mt.dtype)
    got = port(mt, _t(positions), center=center)
    assert got.dtype == (torch.float32 if train else mt.dtype)
    assert _np(want).dtype == np.float32
    assert _max_err(got, _bct(want)) <= MODULE_FP32_TOL
    assert not got[1, 8:].any()
    if not train:
        assert torch.equal(got[0], mt[0])
    np.testing.assert_allclose(
        common._disk_keep_probability(_t(positions), 0.3).numpy(),
        np.asarray(jcommon._disk_keep_probability(jnp.asarray(positions),
                                                  0.3)), rtol=1e-6)


def _model_case(**options):
    """A JAX and a port SimpleConv of tests/test_torch_recipe.py's TINY
    with `options`, the port seeded and moved off its initialization
    (tests/test_torch_convrnn.py's ``_randomized``: seeded running
    statistics too), its flax tree through the port's rules (the leaves
    and shapes of the flax module's init), and the inputs of
    tests/test_torch_recipe.py's ``_model_case`` (recording 1's last five
    sensors padded, the per-recording arrays)."""
    jmodel, port = JaxSimpleConv(**TINY, **options), SimpleConv(
        **TINY, **options)
    rng = np.random.RandomState(5)
    meg = rng.randn(3, 20, 40).astype(np.float32)
    rec_positions = rng.rand(2, 20, 2).astype(np.float32)
    rec_positions[1, 15:] = INVALID
    rec_index = np.array([0, 1, 1])
    subjects = np.array([2, 0, 0], np.int32)
    rec_subjects = np.array([2, 1], np.int32)
    positions = rec_positions[rec_index]
    jargs = ({"meg": jnp.asarray(meg)}, jnp.asarray(subjects),
             jnp.asarray(positions))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *jargs)
    variables = _flax_variables(port, convert.simpleconv_rules(port), {
        coll: {"model": tree} for coll, tree in shapes.items()}, 0)
    params, stats = _randomized({coll: tree["model"] for coll, tree
                                 in variables.items()}, rng)
    convert.load_jax_params(port, {"model": params}, {"model": stats})
    pos_emb = jcommon.fourier_emb(jnp.asarray(rec_positions), 32)
    jkw = dict(pos_emb=pos_emb, rec_index=jnp.asarray(rec_index),
               rec_positions=jnp.asarray(rec_positions),
               rec_subjects=jnp.asarray(rec_subjects))
    kw = dict(pos_emb=_t(pos_emb), rec_index=_t(rec_index),
              rec_positions=_t(rec_positions),
              rec_subjects=_t(rec_subjects).long())
    args = ({"meg": _t(meg)}, _t(subjects).long(), _t(positions))
    return (jmodel, port, {"params": params, "batch_stats": stats},
            (jargs, jkw), (args, kw))


def _apply(jmodel, variables, jcall, train=False):
    """The flax model's apply, jitted (one compile, where an unjitted
    apply compiles each op); in train mode with the draws recorded anew
    (the ``draws`` fixture) and the BatchNorm statistics moved."""
    def run(v, args, kw):
        if not train:
            return jmodel.apply(v, *args, **kw)
        return jmodel.apply(v, *args, train=True, **kw, mutable=[
            "batch_stats"], rngs={"dropout": jax.random.PRNGKey(7)})[0]
    return jax.jit(run)(variables, *jcall)


def _apply_train(jmodel, variables, jcall, draws):
    draws["masks"].clear()
    draws["centers"].clear()
    return _apply(jmodel, variables, jcall, True)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_simpleconv_channel_dropout_matches_flax(draws, train):
    """SimpleConv with ``dropout``: ChannelDropout after the channel
    subsample and before the merger; in train mode with ChannelDropout's
    and the merger's centres replayed, in eval mode zeroing the padded
    sensors (recording 1's last five); rtol = atol = 1e-5."""
    jmodel, port, variables, jcall, call = _model_case(
        dropout=0.2, subsample_meg_channels=16)
    if train:
        want = _apply_train(jmodel, variables, jcall, draws)
        centers = _centers(draws)
        assert len(centers) == 2
        got = port.train()(*call[0], **call[1], centers=centers)
    else:
        want = _apply(jmodel, variables, jcall)
        with torch.no_grad():
            got = port.eval()(*call[0], **call[1])
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


#: SimpleConv's layer options: the rewrite conv and its leaky ReLU,
#: LayerScale and the depthwise post-skip conv
LAYER = dict(rewrite=True, scale=0.1, post_skip=True, relu_leakiness=0.1)
DROPOUTS = dict(conv_dropout=0.1, dropout_input=0.2, dropout=0.1)


@pytest.mark.parametrize("train, options", [
    (False, LAYER), (True, LAYER), (False, {**LAYER, "fused_conv_bn": True}),
    (True, {**LAYER, "fused_conv_bn": True}),
    (True, {**LAYER, **DROPOUTS, "fused_conv_bn": True})],
    ids=["eval", "train", "eval_fused", "train_fused",
         "train_fused_dropouts"])
def test_simpleconv_layer_options_match_flax(draws, train, options):
    """SimpleConv with rewrite, LayerScale and post_skip (and skip) from
    a flax tree bridged by the port's rules (every leaf consumed), in
    eval mode and in train mode (BatchNorm on batch statistics, through
    conv_stats when fused; the draws replayed), against the flax module:
    rtol = atol = 1e-4, the serving test's."""
    jmodel, port, variables, jcall, call = _model_case(**options)
    encoder = variables["params"]["encoder_meg"]
    assert any(k.startswith("LayerScale_") for k in encoder)
    if train:
        want = _apply_train(jmodel, variables, jcall, draws)
        got = port.train()(*call[0], **call[1],
                           centers=_centers(draws),
                           masks=_port_masks(draws["masks"]))
    else:
        want = _apply(jmodel, variables, jcall)
        with torch.no_grad():
            got = port.eval()(*call[0], **call[1])
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_recipe_with_every_layer_option_matches_flax(draws):
    """The clip_conv_tpu recipe's bf16 model with the layer options and
    every dropout in train mode (fused conv_stats, the fused head), the
    draws replayed: within RECIPE_TOL in norm, as tests/test_torch_recipe.py
    holds the recipe without them."""
    jmodel, port, variables, jcall, call = _model_case(
        **STRUCTURE, **BF16, **LAYER, **DROPOUTS, fused_conv_bn=True)
    want = _apply_train(jmodel, variables, jcall, draws)
    got = port.train()(*call[0], **call[1],
                       centers=_centers(draws),
                       masks=_port_masks(draws["masks"]))
    assert got.dtype == torch.bfloat16
    assert _norm_err(got, want) <= RECIPE_TOL


def test_output_layout_btc_is_the_transpose():
    """``output_layout="btc"`` returns the [B, T, F] transpose of "bct"'s
    output, on the same weights, as the flax module does."""
    jmodel, port, variables, jcall, call = _model_case(output_layout="btc")
    want = _apply(jmodel, variables, jcall)
    bct = SimpleConv(**TINY).eval()
    bct.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = port.eval()(*call[0], **call[1])
        ref = bct(*call[0], **call[1])
    assert got.shape == (3, 40, 8)
    assert torch.equal(got, ref.transpose(1, 2))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


#: a ConvRNN with BatchNorm and both dropouts
CONVRNN = dict(in_channels=dict(meg=5, features=3), out_channels=5,
               hidden=dict(meg=8, features=4), n_subjects=3, subject_dim=4,
               lstm=0, batch_norm=True, conv_dropout=0.2, dropout_input=0.3)


def test_convrnn_dropouts_match_flax(draws):
    """ConvRNN in train mode with conv_dropout and dropout_input (the
    encoders' input dropouts and layers' dropouts, then the decoder's),
    flax's masks replayed: within 1e-4 of the output's largest magnitude
    (tests/test_torch_convrnn.py's), and the same number of draws."""
    T = 47
    rng = np.random.RandomState(3)
    inputs = {name: rng.randn(3, c, T).astype(np.float32)
              for name, c in CONVRNN["in_channels"].items()}
    subjects = np.array([0, 2, 1], np.int32)
    jm, port = jconvrnn.ConvRNN(**CONVRNN), convrnn.ConvRNN(**CONVRNN)
    jinputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3), jinputs,
                            jnp.asarray(subjects))
    variables = _flax_variables(
        convrnn.ConvRNN(**CONVRNN), convert.convrnn_rules(port),
        {coll: {"model": tree} for coll, tree in shapes.items()}, 3)
    params, stats = _randomized({coll: tree["model"] for coll, tree
                                 in variables.items()}, rng)
    convert.load_jax_params(port, {"model": params}, {"model": stats})
    draws["masks"].clear()
    want, _ = jax.jit(lambda v, x, s: jm.apply(
        v, x, s, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(1)}))(
            {"params": params, "batch_stats": stats}, jinputs,
            jnp.asarray(subjects))
    # each encoder: its input and its two layers; the decoder: its input
    # and its first layer (no activation, so no dropout, on its last)
    assert len(draws["masks"]) == 8
    got = port.train()({k: _t(v) for k, v in inputs.items()},
                       _t(subjects).long(), masks=_port_masks(draws["masks"]))
    assert _max_err(got, want) <= 1e-4


def test_preset_none():
    """Preset ``none`` sets no feature model, in both packages, and the
    same signature."""
    for module in (config, jconfig):
        cfg = module.apply_preset(module.MainConfig(), "deep_mel")
        assert module.apply_preset(cfg, "none").feature_model_name is None
    port = config.apply_preset(config.MainConfig(), "none")
    original = jconfig.apply_preset(jconfig.MainConfig(), "none")
    assert port.delta() == original.delta()


@pytest.mark.parametrize("option", [
    dict(rewrite=True), dict(post_skip=True), dict(scale=0.1),
    dict(dropout=0.1), dict(output_layout="btc"), dict(conv_dropout=0.1),
    dict(dropout_input=0.1), dict(dropout=0.1, dropout_rescale=False)],
    ids=str)
def test_slice_options_construct_and_run(option):
    """Every SimpleConv option of this slice constructs and runs in train
    mode from a generator to a finite estimate."""
    kw = {**TINY, **option}
    port = SimpleConv(**kw)
    port.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    meg = _t(rng.randn(3, 20, 40).astype(np.float32))
    positions = _t(rng.rand(3, 20, 2).astype(np.float32))
    out = port.train()({"meg": meg}, torch.tensor([0, 1, 2]), positions,
                       generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("option", [dict(conv_impl="concat")], ids=str)
def test_later_options_still_raise(option):
    """``conv_impl`` other than "conv" (a TPU-only lowering, not ported)
    still raises NotImplementedError, naming the option."""
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        SimpleConv(**{**TINY, **option})
