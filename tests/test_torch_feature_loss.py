"""Feature decoding in the PyTorch port against the JAX package: the
slice's feature tracks (WordEmbedding, PartOfSpeech, Pitch, WordSegment)
on the fake study, the categorical class weights, FeatureDecodingLoss in
fp32 and in the clip_conv_tpu recipe's bf16, the wire's exact-label
bound, and three Adam steps and two epochs of the solver with
optim.loss='regression_classification' against the JAX solver's."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args
from test_torch_recipe import CAST_TOL
from test_torch_train import STEPS, _leaf, _noise_driven

from brainmagick_tpu import losses as jlosses
from brainmagick_tpu import train as jtrain
from brainmagick_tpu.convert import _untransform
from brainmagick_tpu.dataset import SegmentBatch
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu_torch import convert, losses, train
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.features import FeaturesBuilder
from brainmagick_tpu_torch.solver import Solver
from brainmagick_tpu_torch.utils import Frequency

#: the slice's features: 300 + 1 + 1 + 1 input channels, 300 + 21 + 1 + 2
#: model outputs
FEATURES = ("WordEmbedding", "PartOfSpeech", "Pitch", "WordSegment")
#: the loss in fp32 against JAX's, relative (sums in other orders)
LOSS_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _args(cache, out, weighting=True):
    """tests/test_solver.py's tiny_args with the slice's features and
    loss, fused_conv_bn as the slice runs it, no merger dropout. (Unfused,
    the conv biases in front of BatchNorm take noise gradients, which
    Adam turns into steps of about lr of either sign: the valid pass's
    running means then part the packages' epochs by 1e-4.)"""
    args = tiny_args(cache, out, loss="regression_classification",
                     features=FEATURES)
    args.optim.use_weighting = weighting
    args.simpleconv.update(merger_dropout=0., fused_conv_bn=True)
    return args


def _port_args(jargs):
    """The port's config of the same overrides, on the CPU."""
    return train.parse_overrides(
        [f"{k}={v!r}" for k, v in jargs.delta().items()]
        + [f"cache={jargs.cache}", f"out_dir={jargs.out_dir}",
           "device=cpu"])


@pytest.fixture(scope="module")
def slice_solvers(tmp_path_factory):
    """Both packages' untrained solvers of the slice (use_weighting on),
    their datasets and scalers built from one shared cache folder."""
    tmp = tmp_path_factory.mktemp("feature_loss")
    cache = tmp / "fake_cache"
    cache.mkdir()
    jargs = _args(cache, tmp)
    args = _port_args(jargs)
    assert args.sig == jargs.sig
    with jenv.temporary(cache=cache), env.temporary(cache=cache):
        yield types.SimpleNamespace(
            cache=cache, jargs=jargs, args=args,
            jax=jtrain.get_solver(jargs, training=True),
            port=train.get_solver(args, training=True))


def test_slice_tracks_equal_the_jax_packages(slice_solvers):
    """Every recording's track of the slice's features (and the word
    mask) equals the JAX package's: the hash embeddings, the rule-based
    tags and the word segments bit for bit, and Pitch too, since the
    fake study's 16 kHz speech needs no resampling
    (tests/test_torch_words.py holds Pitch through the resampler)."""
    for split in ("train", "valid", "test"):
        jsets = getattr(slice_solvers.jax.datasets, split).datasets
        psets = getattr(slice_solvers.port.datasets, split).datasets
        assert len(jsets) == len(psets) > 0
        for jset, pset in zip(jsets, psets):
            assert list(pset.features) == list(jset.features) \
                == list(FEATURES)
            (want, want_sr), (got, got_sr) = jset._get_track(), \
                pset._get_track()
            assert float(got_sr) == float(want_sr)
            np.testing.assert_array_equal(got, want)
            for name in FEATURES:
                assert (got[pset.features.get_slice(name)] != 0).any(), name


def test_categorical_weights_equal_the_jax_packages(slice_solvers):
    """The category counts and the smoothed inverse-frequency weights of
    PartOfSpeech and WordSegment, bit for bit; E_p[w] = 1, and 0 for a
    class never seen."""
    for name in ("PartOfSpeech", "WordSegment"):
        jscaler = slice_solvers.jax.scaler
        scaler = slice_solvers.port.scaler
        np.testing.assert_array_equal(
            scaler.feature_scalers[name].categories_count_,
            jscaler.feature_scalers[name].categories_count_)
        want = jscaler.get_categorical_feature_weights(name)
        got = scaler.get_categorical_feature_weights(name)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        counts = scaler.feature_scalers[name].categories_count_
        probs = counts / counts.sum()
        np.testing.assert_allclose((probs * got).sum(), 1., rtol=1e-6)
        assert (got[counts == 0] == 0).all() and (counts == 0).any()


def _builders():
    """Both packages' builders of FEATURES over the same events."""
    import pandas as pd

    from brainmagick_tpu.features import FeaturesBuilder as JaxBuilder
    from brainmagick_tpu.utils import Frequency as JaxFrequency
    from brainmagick_tpu_torch.events import EventTable

    rows = [dict(kind="word", start=0., duration=.2, modality="audio",
                 language="en", word="cat", word_index=0,
                 word_sequence="cat")]
    return (JaxBuilder(pd.DataFrame(rows), FEATURES, None,
                       JaxFrequency(120.), study="fake"),
            FeaturesBuilder(EventTable.from_records(rows), FEATURES, None,
                            Frequency(120.), study="fake"))


class _Weights:
    """A scaler stand-in with seeded class weights, zero for one class."""

    def __init__(self, builder):
        rng = np.random.RandomState(3)
        self.weights = {}
        for name, feature in builder.items():
            if feature.categorical:
                w = rng.uniform(0.2, 3., feature.cardinality)
                w[1] = 0.
                self.weights[name] = w.astype(np.float32)

    def get_categorical_feature_weights(self, name):
        return self.weights[name]


def _loss_inputs(builder, b=4, t=37, seed=0):
    """Seeded (estimate [B, 324, T], output [B, 303, T] with integer class
    channels, a mask with empty rows, sample weights with zeros)."""
    rng = np.random.RandomState(seed)
    estimate = rng.randn(b, builder.output_dimension, t).astype(np.float32)
    output = rng.randn(b, builder.dimension, t).astype(np.float32)
    for name, feature in builder.items():
        if feature.categorical:
            sl = builder.get_slice(name)
            output[:, sl] = rng.randint(0, feature.cardinality, (b, 1, t))
    mask = rng.rand(b, 1, t) > 0.3
    mask[1] = False
    weight = np.array([1., 0., 1., 1.], np.float32)[:b]
    return estimate, output, mask, weight


CASES = [dict(weights=w, mask=m, sample_weight=s)
         for w in (False, True) for m in (False, True) for s in (False, True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    k for k, v in c.items() if v) or "plain")
def test_feature_loss_matches_jax_fp32(case):
    """FeatureDecodingLoss against the JAX one on the same seeded fp32
    inputs, with and without class weights, mask and sample weights,
    LOSS_RTOL relative; its gradient with respect to the estimate, atol
    1e-7 of entries up to about 1e-3."""
    jbuilder, builder = _builders()
    assert [(s["sl_in"], s["sl_out"]) for s in losses.FeatureDecodingLoss(
        builder).specs] == [(s["sl_in"], s["sl_out"]) for s in
                            jlosses.FeatureDecodingLoss(jbuilder).specs]
    estimate, output, mask, weight = _loss_inputs(builder)
    scaler = _Weights(builder) if case["weights"] else None
    jloss = jlosses.FeatureDecodingLoss(jbuilder, scaler)
    loss = losses.FeatureDecodingLoss(builder, scaler)
    jkw = dict(mask=jnp.asarray(mask) if case["mask"] else None,
               sample_weight=(jnp.asarray(weight) if case["sample_weight"]
                              else None))
    kw = dict(mask=torch.from_numpy(mask) if case["mask"] else None,
              sample_weight=(torch.from_numpy(weight)
                             if case["sample_weight"] else None))
    want, want_grad = jax.value_and_grad(
        lambda e: jloss(e, jnp.asarray(output), **jkw))(jnp.asarray(estimate))
    est = torch.from_numpy(estimate).requires_grad_(True)
    got = loss(est, torch.from_numpy(output), **kw)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(est.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("weights", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("sample_weight", [False, True],
                         ids=["all", "sample_weight"])
def test_feature_loss_matches_jax_bf16(weights, sample_weight):
    """The recipe's bf16 estimate (simpleconv.output_dtype): the mask, the
    log-softmax and the unweighted sums in bf16 as in JAX. Held within
    CAST_TOL to JAX's loss op by op (each op rounding in its JAX type) in
    every case, and to the jitted loss when sample weights come in, as
    the solver always passes them. Without them the mask stays bf16, and
    XLA's fusion on the CPU keeps fp32 where the types say bf16: the
    jitted loss then moves up to 2^-12 from JAX's own op-by-op one. The
    loss keeps JAX's type."""
    jbuilder, builder = _builders()
    estimate, output, mask, weight = _loss_inputs(builder, b=4, t=61,
                                                  seed=1)
    scaler = _Weights(builder) if weights else None
    jloss = jlosses.FeatureDecodingLoss(jbuilder, scaler)
    loss = losses.FeatureDecodingLoss(builder, scaler)
    est = torch.from_numpy(estimate).bfloat16()
    jest = jnp.asarray(est.float().numpy()).astype(jnp.bfloat16)
    sw = weight if sample_weight else None
    jargs = (jest, jnp.asarray(output), jnp.asarray(mask),
             None if sw is None else jnp.asarray(sw))
    want = jloss(*jargs)
    jitted = jax.jit(lambda *a: jloss(*a))(*jargs)
    got = loss(est, torch.from_numpy(output), torch.from_numpy(mask),
               None if sw is None else torch.from_numpy(sw))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    value = got.float().item()
    err = abs(value - float(want)) / abs(float(want))
    err_jit = abs(value - float(jitted)) / abs(float(jitted))
    print(f"bf16 loss: port {value:.7f}, jax {float(want):.7f} (relative "
          f"{err:.1e}), jitted {float(jitted):.7f} (relative {err_jit:.1e}"
          f"); CAST_TOL {CAST_TOL:.1e}")
    assert err <= CAST_TOL
    if sample_weight:
        assert err_jit <= CAST_TOL


def test_bf16_wire_bounds_the_labels():
    """A categorical feature with more than 256 classes cannot cross a bf16
    wire exactly (257 rounds to 256): the loss refuses it when built; 256
    classes, and any count on an fp32 wire, are accepted."""
    _, builder = _builders()
    assert torch.tensor(257.).bfloat16().item() == 256.
    losses.FeatureDecodingLoss(builder, wire_dtype="bfloat16")
    builder["PartOfSpeech"].cardinality = 257
    with pytest.raises(ValueError, match="PartOfSpeech has 257 classes"):
        losses.FeatureDecodingLoss(builder, wire_dtype="bfloat16")
    losses.FeatureDecodingLoss(builder, wire_dtype="float32")
    losses.FeatureDecodingLoss(builder)
    builder["PartOfSpeech"].cardinality = 256
    losses.FeatureDecodingLoss(builder, wire_dtype="bfloat16")


def test_solver_takes_regression_classification_only(slice_solvers):
    """The solver builds the loss from the used features (with the
    scaler's weights when optim.use_weighting), refuses it without them,
    and still refuses a loss it does not have."""
    port = slice_solvers.port
    assert isinstance(port.feature_loss, losses.FeatureDecodingLoss)
    weights = {s["name"]: s["weights"] for s in port.feature_loss.specs}
    assert weights["WordEmbedding"] is None and weights["Pitch"] is None
    np.testing.assert_array_equal(
        weights["PartOfSpeech"].cpu().numpy(),
        port.scaler.get_categorical_feature_weights("PartOfSpeech"))
    kwargs = dict(norm_arrays=port.norm_arrays)
    with pytest.raises(ValueError, match="used features"):
        Solver(slice_solvers.args, port.model, **kwargs)
    with pytest.raises(ValueError, match="scaler"):
        Solver(slice_solvers.args, port.model,
               used_features=port.used_features, **kwargs)
    args = train.parse_overrides(["optim.loss=bce"])
    with pytest.raises(NotImplementedError, match="bce"):
        Solver(args, port.model, **kwargs)


def _batches(solver):
    """STEPS batches of 6 items, 3 from each training recording."""
    dsets = solver.datasets.train.datasets
    return [SegmentBatch.collate([d[i] for d in dsets
                                  for i in range(3 * s, 3 * s + 3)])
            for s in range(STEPS)]


def test_train_steps_match_jax_solver(slice_solvers):
    """Three Trainer.steps of the slice (class weights from the port's own
    scaler) against the JAX solver's jitted _build_step(True, False,
    False) on the same batches, held as tests/test_torch_train.py holds
    clip: every loss rtol 1e-5, the first step's gradient of every
    parameter atol 1e-5, every parameter after the steps within 0.01 lr
    (the noise-driven entries within 2 lr a step), the running variances
    rtol 1e-5 and means atol 1e-5."""
    solver, port = slice_solvers.jax, slice_solvers.port
    state = jax.device_get(solver.state)
    trainer = train.Trainer(
        solver.args, solver.model.in_channels["meg"],
        solver.model.out_channels, solver.model.n_subjects,
        state["params"], state["batch_stats"],
        {k: np.asarray(v) for k, v in solver.norm_arrays.items()},
        device="cpu", generator=torch.Generator().manual_seed(0),
        used_features=port.used_features, scaler=port.scaler)
    assert trainer.model.out_channels == 324
    assert trainer.model.encoders["meg"].fused == [True, True]
    step = solver._build_step(True, False, False)
    state = jax.tree_util.tree_map(jnp.array, solver.state)
    rng = jax.random.PRNGKey(0)
    rules = convert.simpleconv_rules(trainer.model)
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
        print(f"step {i}: port {got['loss'].item():.6f}, jax "
              f"{float(want['loss']):.6f}")
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-5)
        assert got["keep"].item() == float(want["keep"])
        if i == 0:
            for tkey, fpath, kind, coll in rules:
                if coll == "params":
                    np.testing.assert_allclose(
                        trainer.model.get_parameter(tkey).grad.numpy(),
                        _untransform(kind, _leaf(grads, fpath)),
                        rtol=0, atol=1e-5, err_msg=tkey)
    lr = solver.args.optim.lr
    state = jax.device_get(state)
    for tkey, fpath, kind, coll in rules:
        want = _untransform(kind, _leaf(state[coll], fpath))
        if coll == "params":
            got = trainer.model.get_parameter(tkey).detach().numpy()
            atol = np.where(_noise_driven(trainer.model, tkey),
                            2 * STEPS * lr, 0.01 * lr)
            assert (np.abs(got - want) <= atol).all(), tkey
        elif tkey.endswith("running_var"):
            got = trainer.model.get_buffer(tkey).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=tkey)
        else:
            got = trainer.model.get_buffer(tkey).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=tkey)


def test_epochs_match_jax_solver_and_cli(tmp_path):
    """Two epochs of ``Solver.train`` of the slice from the JAX solver's
    initial weights, against the JAX solver's: the train and valid losses
    of each epoch within 1e-4 relative (tests/test_torch_epochs.py's
    LOSS_RTOL), the same best epoch, and the test stage's accuracy, L2
    and correlation for each feature within rtol 1e-4, atol 1e-6. Then ``train.main`` on the
    same overrides in a fresh out_dir, the CLI's path, trains one epoch
    and writes its metrics into history-torch.json."""
    import json

    cache = tmp_path / "fake_cache"
    cache.mkdir()
    jargs = _args(cache, tmp_path / "j")
    args = _port_args(jargs)
    with jenv.temporary(cache=cache):
        jsolver = jtrain.get_solver(jargs)
        state = jax.device_get(jsolver.state)
    # the port's solver is built before the JAX run writes its
    # checkpoint.pkl, which a port training run in the folder resumes
    with env.temporary(cache=cache):
        solver = train.get_solver(args)
        convert.load_jax_params(solver.model, state["params"],
                                state["batch_stats"])
    assert solver.history == [] and solver.epoch == 1
    with jenv.temporary(cache=cache):
        jsolver.train()
    with env.temporary(cache=cache):
        solver.train()
    assert len(solver.history) == len(jsolver.history) == 2
    keys = {f"{kind}_{name}" for name in ("WordEmbedding", "Pitch")
            for kind in ("l2", "corr")} \
        | {"acc_PartOfSpeech", "acc_WordSegment"}
    for got, want in zip(solver.history, jsolver.history):
        assert sorted(got) == sorted(want)
        for stage in ("train", "valid"):
            print(f"{stage} loss: port {got[stage]['loss']:.6f}, jax "
                  f"{want[stage]['loss']:.6f}")
            np.testing.assert_allclose(got[stage]["loss"],
                                       want[stage]["loss"], rtol=1e-4)
        if "test" in want:
            print(f"test: port {got['test']}, jax {want['test']}")
            assert set(got["test"]) == set(want["test"]) == keys
            for name, value in want["test"].items():
                np.testing.assert_allclose(got["test"][name], value,
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=name)
    assert solver.best_epoch == jsolver.best_epoch
    assert any("test" in h for h in solver.history)

    out = tmp_path / "cli"
    argv = [f"{k}={v!r}" for k, v in jargs.delta().items()] \
        + [f"cache={cache}", f"out_dir={out}", "device=cpu",
           "optim.epochs=1"]
    train.main(argv)
    folder = train.parse_overrides(argv).xp_folder
    history = json.loads((folder / "history-torch.json").read_text())
    assert len(history) == 1 and set(history[0]["test"]) == keys
    assert np.isfinite(history[0]["train"]["loss"])
