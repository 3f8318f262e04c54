"""The PyTorch port's model blocks against the flax modules on the same
numpy inputs, after bridging the flax weights into the port
(brainmagick_tpu_torch.convert)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainmagick_tpu import convert as jconvert
from brainmagick_tpu.models import common as jcommon
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu_torch import convert
from brainmagick_tpu_torch.config import MainConfig, apply_preset
from brainmagick_tpu_torch.models import build_model, common
from brainmagick_tpu_torch.models.simpleconv import SimpleConv

INVALID = common.INVALID_POSITION


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bct(x_btc):
    """flax channels-last [B, T, C] output -> the port's [B, C, T]."""
    return np.swapaxes(np.asarray(x_btc), 1, 2)


def _random_stats(stats, seed):
    """Seeded BatchNorm running stats in the shape of a flax tree."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "mean":
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(stats))


@pytest.mark.parametrize("dim", [32, 2048])
def test_fourier_emb_matches_jax(dim):
    # atol 1e-4: at dim 2048 the arguments reach ~330 rad, where one fp32
    # ulp of the angle is ~3e-5 and cos/sin implementations differ
    pos = np.random.RandomState(0).rand(3, 20, 2).astype(np.float32)
    np.testing.assert_allclose(
        common.fourier_emb(_t(pos), dim).numpy(),
        np.asarray(jcommon.fourier_emb(jnp.asarray(pos), dim)), atol=1e-4)
    with pytest.raises(ValueError):
        common.fourier_emb(_t(pos), 30)


def _merger_inputs():
    rng = np.random.RandomState(1)
    B, C, T, R = 4, 12, 20, 3
    meg = rng.randn(B, C, T).astype(np.float32)
    rec_positions = rng.rand(R, C, 2).astype(np.float32)
    rec_positions[1, 9:] = INVALID          # some invalid sensors
    rec_positions[2] = INVALID              # a wholly masked recording
    rec_index = np.array([0, 1, 1, 0])
    return meg, rec_positions, rec_index


def test_channel_merger_per_recording_matches_jax():
    meg, rec_positions, rec_index = _merger_inputs()
    jm = jcommon.ChannelMerger(8, pos_dim=32)
    positions = rec_positions[rec_index]
    pos_emb = jcommon.fourier_emb(jnp.asarray(rec_positions), 32)
    kwargs = dict(pos_emb=pos_emb, rec_index=jnp.asarray(rec_index),
                  rec_positions=jnp.asarray(rec_positions))
    meg_btc = jnp.asarray(np.swapaxes(meg, 1, 2))
    variables = jm.init(jax.random.PRNGKey(0), meg_btc,
                        jnp.asarray(positions), jnp.zeros(4, jnp.int32),
                        **kwargs)
    want = jm.apply(variables, meg_btc, jnp.asarray(positions),
                    jnp.zeros(4, jnp.int32), **kwargs)
    port = common.ChannelMerger(8, pos_dim=32)
    convert.load_by_rules(port, [("heads", ("heads",), "copy", "params")],
                          variables["params"], {})
    got = port(_t(meg), _t(positions), pos_emb=_t(pos_emb),
               rec_index=_t(rec_index), rec_positions=_t(rec_positions))
    np.testing.assert_allclose(got.detach().numpy(), _bct(want), atol=1e-5)
    # the masked recording's attention row stays finite (uniform)
    all_masked = port(_t(meg), _t(rec_positions[[2, 2, 2, 2]]))
    assert torch.isfinite(all_masked).all()


def test_channel_merger_per_sample_matches_jax():
    meg, rec_positions, rec_index = _merger_inputs()
    positions = rec_positions[[0, 1, 2, 1]]  # sample 2 fully masked
    jm = jcommon.ChannelMerger(8, pos_dim=32)
    meg_btc = jnp.asarray(np.swapaxes(meg, 1, 2))
    subjects = jnp.zeros(4, jnp.int32)
    variables = jm.init(jax.random.PRNGKey(1), meg_btc,
                        jnp.asarray(positions), subjects)
    want = jm.apply(variables, meg_btc, jnp.asarray(positions), subjects)
    port = common.ChannelMerger(8, pos_dim=32)
    convert.load_by_rules(port, [("heads", ("heads",), "copy", "params")],
                          variables["params"], {})
    got = port(_t(meg), _t(positions))
    np.testing.assert_allclose(got.detach().numpy(), _bct(want), atol=1e-5)
    assert np.isfinite(got.detach().numpy()).all()


def test_subject_layers_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(5, 6, 9).astype(np.float32)   # [B, C, T]
    subjects = np.array([0, 2, 1, 2, 0])
    jl = jcommon.SubjectLayers(6, 5, 3)
    x_btc = jnp.asarray(np.swapaxes(x, 1, 2))
    variables = jl.init(jax.random.PRNGKey(2), x_btc, jnp.asarray(subjects))
    want = jl.apply(variables, x_btc, jnp.asarray(subjects))
    port = common.SubjectLayers(6, 5, 3)
    convert.load_by_rules(
        port, [("weights", ("weights",), "copy", "params")],
        variables["params"], {})
    np.testing.assert_allclose(port(_t(x), _t(subjects)).detach().numpy(),
                               _bct(want), atol=1e-5)


@pytest.mark.parametrize("gelu_exact", [True, False])
def test_conv_sequence_matches_jax(gelu_exact):
    """Depth 4, dilation period 2, GLU every 2 layers, BatchNorm on seeded
    running stats, erf and tanh GELU."""
    channels = (8, 12, 12, 12, 12)
    kw = dict(kernel=3, dilation_growth=2, dilation_period=2, skip=True,
              batch_norm=True, glu=2, glu_context=1)
    jseq = jcommon.ConvSequence(
        channels, stride=1,
        activation=jcommon.get_activation(True, gelu_exact=gelu_exact), **kw)
    x = np.random.RandomState(3).randn(3, 8, 30).astype(np.float32)
    x_btc = jnp.asarray(np.swapaxes(x, 1, 2))
    variables = jseq.init(jax.random.PRNGKey(3), x_btc)
    stats = _random_stats(variables["batch_stats"], seed=4)
    want = jseq.apply({"params": variables["params"], "batch_stats": stats},
                      x_btc)
    port = common.ConvSequence(
        channels, activation=common.get_activation(True,
                                                   gelu_exact=gelu_exact),
        **kw).eval()
    rules = jconvert.conv_sequence_rules(
        "", (), channels=channels, batch_norm=True, skip=True, scale=None,
        rewrite=False, post_skip=False, glu=2, dropout=0.,
        dropout_input=0., activation_on_last=True, decode=False)
    convert.load_by_rules(port, rules, variables["params"], stats)
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), _bct(want),
                               rtol=1e-4, atol=1e-4)


#: tests/test_solver.py tiny_args simpleconv, at a 20-sensor input
TINY = dict(hidden=24, depth=2, kernel_size=3, dilation_period=2, skip=True,
            glu=2, glu_context=1, merger=True, merger_channels=16,
            merger_pos_dim=32, initial_linear=16, gelu=True,
            batch_norm=True, subject_layers=True, subject_dim=0,
            complex_out=True)


def _tiny_pair(**overrides):
    kw = {**TINY, **overrides}
    hidden = kw.pop("hidden")
    common_kw = dict(in_channels={"meg": 20}, out_channels=8,
                     hidden={"meg": hidden}, n_subjects=2, **kw)
    return JaxSimpleConv(**common_kw), SimpleConv(**common_kw).eval()


def _tiny_inputs():
    rng = np.random.RandomState(5)
    B, C, T = 3, 20, 40
    meg = rng.randn(B, C, T).astype(np.float32)
    rec_positions = rng.rand(2, C, 2).astype(np.float32)
    rec_positions[1, 15:] = INVALID
    rec_index = np.array([0, 1, 1])
    return meg, rec_positions, rec_index, rec_index.astype(np.int32)


def _tiny_jax_variables(jmodel, seed=0):
    meg, rec_positions, rec_index, subjects = _tiny_inputs()
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            {"meg": jnp.asarray(meg)}, jnp.asarray(subjects),
                            jnp.asarray(rec_positions[rec_index]))
    params = {"model": jax.device_get(variables["params"])}
    stats = {"model": _random_stats(variables["batch_stats"], seed + 1)}
    return params, stats


@pytest.mark.parametrize("per_recording", [True, False])
@pytest.mark.parametrize("overrides", [dict(), dict(gelu_exact=False),
                                       dict(initial_depth=2,
                                            initial_nonlin=True,
                                            subject_layers_dim="hidden"),
                                       dict(complex_out=False,
                                            linear_out=True),
                                       dict(complex_out=False),
                                       dict(gelu=False, relu_leakiness=0.1,
                                            glu_glu=False, groups=2,
                                            conv_dropout=0.1,
                                            dropout_input=0.1)], ids=str)
def test_simpleconv_matches_jax(overrides, per_recording):
    """The whole SimpleConv at tiny_args size, bridged with
    load_jax_params: rtol/atol 1e-4."""
    jmodel, port = _tiny_pair(**overrides)
    params, stats = _tiny_jax_variables(jmodel)
    convert.load_jax_params(port, params, stats)
    meg, rec_positions, rec_index, subjects = _tiny_inputs()
    positions = rec_positions[rec_index]
    jkw, kw = {}, {}
    if per_recording:
        pos_emb = jcommon.fourier_emb(jnp.asarray(rec_positions), 32)
        jkw = dict(pos_emb=pos_emb, rec_index=jnp.asarray(rec_index),
                   rec_positions=jnp.asarray(rec_positions))
        kw = dict(pos_emb=_t(pos_emb), rec_index=_t(rec_index),
                  rec_positions=_t(rec_positions))
    want = jmodel.apply({"params": params["model"],
                         "batch_stats": stats["model"]},
                        {"meg": jnp.asarray(meg)}, jnp.asarray(subjects),
                        jnp.asarray(positions), **jkw)
    with torch.no_grad():
        got = port({"meg": _t(meg)}, _t(subjects).long(), _t(positions),
                   **kw)
    assert got.shape == (3, 8, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("paper", [False, True])
def test_convert_rules_read_the_port_model(paper):
    """brainmagick_tpu.convert.simpleconv_rules reads the port module as it
    reads the flax one, and names exactly the port's state-dict keys."""
    if paper:
        args = apply_preset(MainConfig(), "clip_conv")
        kw = dict(args.simpleconv)
        hidden = kw.pop("hidden")
        common_kw = dict(in_channels={"meg": 273}, out_channels=1024,
                         hidden={"meg": hidden}, n_subjects=4, **kw)
        jmodel, port = JaxSimpleConv(**common_kw), SimpleConv(**common_kw)
    else:
        jmodel, port = _tiny_pair()
    rules = jconvert.simpleconv_rules(port, tprefix="")
    assert rules == jconvert.simpleconv_rules(jmodel, tprefix="")
    keys = {r[0] for r in rules}
    assert keys == {k for k in port.state_dict()
                    if not k.endswith("num_batches_tracked")}
    if paper:
        assert {"merger.heads", "initial_linear.0.weight",
                "subject_layers.weights", "encoders.meg.sequence.9.1.weight",
                "encoders.meg.glus.9.0.weight", "final.0.weight",
                "final.2.weight"} <= keys


def test_bridge_consumes_every_leaf():
    jmodel, port = _tiny_pair()
    params, stats = _tiny_jax_variables(jmodel)
    # a leaf the port does not know
    extra = {"model": {**params["model"],
                       "Stray_0": {"kernel": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="Stray_0"):
        convert.load_jax_params(port, extra, stats)
    # a leaf the port needs and the tree lacks
    missing = {"model": {k: v for k, v in params["model"].items()
                         if k != "SubjectLayers_0"}}
    with pytest.raises(KeyError, match="SubjectLayers_0"):
        convert.load_jax_params(port, missing, stats)
    stats_missing = {"model": {"encoder_meg": {}}}
    with pytest.raises(KeyError, match="BatchNorm_0"):
        convert.load_jax_params(port, params, stats_missing)
    convert.load_jax_params(port, params, stats)


@pytest.mark.parametrize("option", [
    dict(dual_path=1), dict(n_fft=4), dict(conv_impl="dots"),
    dict(fused_head=True),
    dict(bn_conv_bias=False), dict(rewrite=True), dict(post_skip=True),
    dict(scale=0.1), dict(concatenate=True), dict(subject_dim=4),
    dict(merger_per_subject=True), dict(dtype="bfloat16")], ids=str)
def test_unsupported_options_raise(option):
    kw = {**TINY, **option}
    hidden = kw.pop("hidden")
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=name):
        SimpleConv(in_channels={"meg": 20}, out_channels=8,
                   hidden={"meg": hidden}, n_subjects=2, **kw)


def test_build_model_seeded_and_eval_only():
    args = MainConfig()
    args.simpleconv.update(TINY)
    make = functools.partial(build_model, args, 20, 8, 2, "cpu")
    a = make(torch.Generator().manual_seed(7))
    b = make(torch.Generator().manual_seed(7))
    c = make(torch.Generator().manual_seed(8))
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.merger.heads, c.merger.heads)
    assert not a.training
    # train mode runs; its merger dropout disk needs a generator or centre
    meg, rec_positions, rec_index, subjects = _tiny_inputs()
    a.train()
    with pytest.raises(ValueError, match="generator"):
        a({"meg": _t(meg)}, _t(subjects).long(),
          _t(rec_positions[rec_index]))
    out = a({"meg": _t(meg)}, _t(subjects).long(),
            _t(rec_positions[rec_index]),
            generator=torch.Generator().manual_seed(0))
    assert out.shape == (3, 8, 40) and torch.isfinite(out).all()
    args.simpleconv.update(conv_dropout=0.1)
    with pytest.raises(NotImplementedError, match="conv_dropout"):
        make().train()({"meg": _t(meg)}, _t(subjects).long(),
                       _t(rec_positions[rec_index]))
    args.simpleconv.update(conv_dropout=0.)
    args.task.type = "encode"
    with pytest.raises(NotImplementedError, match="encode"):
        make()
