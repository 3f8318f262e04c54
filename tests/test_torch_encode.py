"""The encode task in the PyTorch port against the JAX package: SimpleConv's
features branch, subject embedding and concatenated branch, the task
wiring (the MEG prompt, the ground truth under task.lowpass, the prompt's
trim), three Adam steps of Trainer against the JAX solver's jitted step
for the convrnn preset's structure and for SimpleConv encoding, and two
epochs of the solver against the JAX solver's, with the CLI beside them
(the convrnn and decoder_convrnn presets at tiny widths).

Tolerances, as tests/test_torch_train.py and tests/test_torch_epochs.py
state them: forwards 1e-4 relative to the largest magnitude; losses 1e-5
relative and first-step gradients 1e-5 absolute (entries reach about 1);
parameters after three steps within 0.01 lr; epoch losses and the test
stage's corr_meg 1e-4 relative."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args
from test_torch_train import STEPS, _leaf, _noise_driven

from brainmagick_tpu import train as jtrain
from brainmagick_tpu.config import MainConfig as JaxConfig
from brainmagick_tpu.dataset import SegmentBatch
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.models.convrnn import ConvRNN as JaxConvRNN
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu.solver import Solver as JaxSolver
from brainmagick_tpu_torch import convert, train
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.models.simpleconv import SimpleConv
from brainmagick_tpu_torch.solver import Solver

FORWARD_TOL = 1e-4
#: the convrnn preset's structure at tiny widths
CONVRNN = dict(hidden={"meg": 12, "features": 4}, lstm=2, subject_dim=4)


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
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FORWARD_TOL, (what, err)


#: SimpleConv's two-branch options: the encode task's features branch
#: beside the MEG's head, the subject embedding after the subject layers,
#: one branch over the concatenated inputs, and the fused conv + BatchNorm
BRANCHES = {"features": {},
            "concatenate_subject_dim": dict(concatenate=True, subject_dim=4),
            "fused_subject_dim": dict(subject_dim=4, fused_conv_bn=True)}


@pytest.mark.parametrize("option", list(BRANCHES))
def test_simpleconv_branches_match_jax(option):
    """A two-input SimpleConv (the tiny merger, initial conv and subject
    layers on the MEG only; the features through their own encoder, or
    both through one) against the flax module from its tree through
    convert.load_jax_params, in eval mode and in train mode (batch
    statistics; no merger dropout), at rtol 1e-4 of the output."""
    kw = dict(in_channels={"meg": 20, "features": 6}, out_channels=20,
              hidden={"meg": 16, "features": 8}, n_subjects=3, depth=2,
              kernel_size=3, dilation_period=2, skip=True, glu=2,
              glu_context=1, merger=True, merger_channels=12,
              merger_pos_dim=32, merger_dropout=0., initial_linear=10,
              gelu=True, batch_norm=True, subject_layers=True,
              complex_out=True, **{"subject_dim": 0, **BRANCHES[option]})
    rng = np.random.RandomState(4)
    inputs = {"meg": rng.randn(3, 20, 40).astype(np.float32),
              "features": rng.randn(3, 6, 40).astype(np.float32)}
    positions = rng.rand(3, 20, 2).astype(np.float32)
    subjects = np.array([0, 2, 1], np.int32)
    jargs = ({k: jnp.asarray(v) for k, v in inputs.items()},
             jnp.asarray(subjects), jnp.asarray(positions))
    jm = JaxSimpleConv(**kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4), *jargs)
    params = {"model": jax.device_get(variables["params"])}
    stats = {"model": jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        jax.device_get(variables["batch_stats"]))}
    port = SimpleConv(**kw)
    convert.load_jax_params(port, params, stats)
    assert sorted(port.encoders) == (
        ["concat"] if "concatenate" in option else ["features", "meg"])
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    for train_mode in (False, True):
        want = apply({"params": params["model"],
                      "batch_stats": stats["model"]}, *jargs,
                     train=train_mode,
                     mutable=("batch_stats",) if train_mode else False)
        want = want[0] if train_mode else want
        got = port.train(train_mode)(
            {k: _t(v) for k, v in inputs.items()}, _t(subjects).long(),
            _t(positions))
        _close(got.detach().numpy(), want, f"train={train_mode}")


@pytest.mark.parametrize("lowpass", [
    dict(lowpass=0.), dict(lowpass=10.), dict(lowpass=10., lowpass_gt=False),
    dict(lowpass=10., lowpass_gt=False, lowpass_gt_test=True)], ids=str)
def test_encode_wiring_matches_jax(lowpass):
    """The encode task's wiring against the JAX solver's, in training and
    not: the MEG prompt (the first meg_init x sample_rate samples, zeros
    after), the features as the second input, the ground truth lowpassed
    with lowpass_gt in training or with lowpass_gt_test, and the limit
    the JAX solver trims the estimate, output and mask by."""
    args = JaxConfig()
    args.task.type = "encode"
    for name, value in lowpass.items():
        setattr(args.task, name, value)
    rng = np.random.RandomState(0)
    meg = rng.randn(3, 5, 180).astype(np.float32)
    features = rng.randn(3, 4, 180).astype(np.float32)
    mask = rng.rand(3, 1, 180) > 0.5
    jself = types.SimpleNamespace(args=args)
    jself._offsets = lambda: JaxSolver._offsets(jself)
    pself = types.SimpleNamespace(args=args)
    pself._offsets = lambda: Solver._offsets(pself)
    pself._prompt_limit = lambda: Solver._prompt_limit(pself)
    for training in (False, True):
        inputs, output, _, limit = JaxSolver._task_wiring(
            jself, jnp.asarray(meg), jnp.asarray(features),
            jnp.asarray(mask), train=training)
        got, got_output, got_mask = Solver._task_wiring(
            pself, _t(meg), _t(features), _t(mask), train=training)
        assert limit == Solver._prompt_limit(pself) == 36
        assert sorted(got) == ["features", "meg"]
        np.testing.assert_allclose(got["meg"].numpy(), inputs["meg"],
                                   rtol=1e-6, atol=1e-6)
        assert not got["meg"][..., limit:].any()
        np.testing.assert_array_equal(got["features"].numpy(),
                                      inputs["features"])
        np.testing.assert_allclose(got_output.numpy(), output, rtol=1e-6,
                                   atol=1e-6)
        assert got_mask.all()
    lowpassed = lowpass["lowpass"] and (lowpass.get("lowpass_gt", True)
                                        or lowpass.get("lowpass_gt_test"))
    assert np.array_equal(got_output.numpy(), meg) != bool(lowpassed)


def _encode_args(cache, out, convrnn):
    """tests/test_solver.py's tiny_args for the encode task under an L1
    loss, a 0.5 s baseline (the test stage's trim is then 24 samples),
    and either the convrnn preset's structure at tiny widths or the tiny
    SimpleConv with fused_conv_bn and no merger dropout."""
    args = tiny_args(cache, out, loss="l1", task="encode")
    args.dset.tmin = -0.5
    if convrnn:
        args.model_name = "convrnn"
        args.convrnn.update(CONVRNN)
    else:
        args.simpleconv.update(merger_dropout=0., fused_conv_bn=True)
    return args


def _port_args(jargs, *extra):
    """The port's config of the same overrides, on the CPU."""
    return train.parse_overrides(
        [f"{k}={v!r}" for k, v in jargs.delta().items()]
        + [f"cache={jargs.cache}", f"out_dir={jargs.out_dir}",
           "device=cpu", *extra])


@pytest.fixture(autouse=True, scope="module")
def _jitted_inits():
    """The JAX solvers initialize their models through a jitted init:
    flax's unjitted one compiles each draw of each shape on its own, for
    seconds on the CPU. The draws are the same."""
    saved = {cls: cls.init for cls in (JaxConvRNN, JaxSimpleConv)}

    def jitted(cls):
        def init(self, rngs, *args, **kwargs):
            return jax.jit(lambda r, *a: saved[cls](self, r, *a, **kwargs))(
                rngs, *args)
        return init
    for cls in saved:
        cls.init = jitted(cls)
    yield
    for cls, init in saved.items():
        cls.init = init


@pytest.fixture(scope="module")
def jax_solvers(tmp_path_factory):
    """Untrained JAX solvers of the encode task with an Adam optimizer,
    the convrnn structure's and SimpleConv's, over one cache folder."""
    tmp = tmp_path_factory.mktemp("encode")
    cache = tmp / "fake_cache"
    cache.mkdir()
    with jenv.temporary(cache=cache):
        yield {name: jtrain.get_solver(
            _encode_args(cache, tmp / name, name == "convrnn"),
            training=True) for name in ("convrnn", "simpleconv")}


def _batches(solver):
    """STEPS batches of 6 items, 3 from each training recording."""
    dsets = solver.datasets.train.datasets
    return [SegmentBatch.collate([d[i] for d in dsets
                                  for i in range(3 * s, 3 * s + 3)])
            for s in range(STEPS)]


@pytest.mark.parametrize("name", ["convrnn", "simpleconv"])
def test_train_steps_match_jax_solver(jax_solvers, name):
    """The eval forward (estimate, output and mask trimmed by the prompt)
    at 1e-4, then three Trainer.steps against the JAX solver's jitted
    _build_step(True, False, False) on the same batches: every loss rtol
    1e-5, keep exactly, the first step's gradient of every parameter atol
    1e-5, every parameter after the steps within 0.01 lr (SimpleConv's
    noise-driven merger column within 2 lr a step, see
    tests/test_torch_train.py), running statistics rtol 1e-5. Each LSTM
    gate's one bias is held to flax's: an LSTM that trained a second
    bias beside it would move their sum twice as fast under Adam, about
    3 lr off after three steps."""
    solver = jax_solvers[name]
    model = solver.model
    state = jax.device_get(solver.state)
    trainer = train.Trainer(
        solver.args, model.in_channels["meg"], model.out_channels,
        model.n_subjects, state["params"], state["batch_stats"],
        {k: np.asarray(v) for k, v in solver.norm_arrays.items()
         if v is not None},
        device="cpu", generator=torch.Generator().manual_seed(0),
        features_channels=model.in_channels["features"])
    assert sorted(trainer.model.encoders) == ["features", "meg"]
    batches = _batches(solver)
    limit = int(solver.args.task.meg_init * solver.args.dset.sample_rate)
    want = solver.forward_batch(batches[0])
    got = trainer.solver.forward_batch(batches[0])
    assert got[0].shape[-1] == batches[0].meg.shape[-1] - limit
    _close(got[0].numpy(), want[0], "estimate")
    _close(got[1].numpy(), want[1], "output")
    np.testing.assert_array_equal(got[2].numpy(), want[2])

    step = solver._build_step(True, False, False)
    jstate = jax.tree_util.tree_map(jnp.array, solver.state)
    rng = jax.random.PRNGKey(0)
    rules = convert.model_rules(trainer.model)
    for i, batch in enumerate(batches):
        arrays = batch.to_device()
        pad = jnp.ones(len(batch), jnp.float32)
        if i == 0:
            grads = jax.device_get(jax.grad(lambda p: solver._loss_and_aux(
                p, jstate["batch_stats"], arrays, solver.norm_arrays, pad,
                None, None, rng, True, False)[0])(jstate["params"]))
        jstate, want = step(jstate, arrays, solver.norm_arrays, pad, None,
                            None, rng)
        got = trainer.step(batch)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-5)
        assert got["keep"].item() == float(want["keep"])
        if i == 0:
            for tkey, fpath, kind, coll in rules:
                if coll == "params":
                    np.testing.assert_allclose(
                        trainer.model.get_parameter(tkey).grad.numpy(),
                        convert._untransform(kind, _leaf(grads, fpath)),
                        rtol=0, atol=1e-5, err_msg=tkey)
    lr = solver.args.optim.lr
    jstate = jax.device_get(jstate)
    for tkey, fpath, kind, coll in rules:
        want = convert._untransform(kind, _leaf(jstate[coll], fpath))
        if coll == "params":
            got = trainer.model.get_parameter(tkey).detach().numpy()
            noise = (_noise_driven(trainer.model, tkey)
                     if tkey == "merger.heads" else False)
            atol = np.where(noise, 2 * STEPS * lr, 0.01 * lr)
            assert (np.abs(got - want) <= atol).all(), tkey
        else:
            got = trainer.model.get_buffer(tkey).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=tkey)


def test_epochs_match_jax_solver_and_cli(jax_solvers, tmp_path):
    """Two epochs of ``Solver.train`` of the convrnn structure from the
    JAX solver's initial weights, against the JAX solver's (the fixture's,
    which this last test of the file trains): the train and valid losses
    within 1e-4 relative, the same best epoch, and the test stage's
    corr_meg (trimmed as the JAX solver trims it) within 1e-4. Then
    ``train.main`` on the same overrides in a fresh out_dir trains one
    epoch and writes history-torch.json and done-torch.json, and the
    decoder_convrnn preset at tiny widths trains one epoch to an
    acc_WordSegment in [0, 1]."""
    jsolver = jax_solvers["convrnn"]
    jargs = jsolver.args
    cache = jargs.cache
    args = _port_args(jargs)
    assert args.sig == jargs.sig
    with jenv.temporary(cache=cache):
        state = jax.device_get(jsolver.state)
        jsolver.train()
    with env.temporary(cache=cache):
        solver = train.get_solver(args)
        convert.load_jax_params(solver.model, state["params"],
                                state["batch_stats"])
        solver.train()
    for got, want in zip(solver.history, jsolver.history):
        assert sorted(got) == sorted(want)
        for stage in ("train", "valid"):
            np.testing.assert_allclose(got[stage]["loss"],
                                       want[stage]["loss"], rtol=1e-4)
        if "test" in want:
            assert set(got["test"]) == set(want["test"]) == {"corr_meg"}
            np.testing.assert_allclose(got["test"]["corr_meg"],
                                       want["test"]["corr_meg"], rtol=1e-4,
                                       atol=1e-6)
    assert solver.best_epoch == jsolver.best_epoch
    assert any("test" in h for h in solver.history)

    out = tmp_path / "cli"
    for argv, key in (
            ([f"{k}={v!r}" for k, v in jargs.delta().items()], "corr_meg"),
            (["preset=decoder_convrnn", 'dset.selections=["fake"]',
              "dset.n_recordings=2", "dset.min_n_blocks_per_split=1",
              "dset.condition=1.0", "dset.tmin=-0.2", "dset.tmax=1.0",
              "dset.test_ratio=0.3", "dset.valid_ratio=0.2",
              "optim.batch_size=8", f"convrnn.hidden={{'meg': 12}}",
              "convrnn.lstm=2", "convrnn.subject_dim=4"],
             "acc_WordSegment")):
        argv = argv + [f"cache={cache}", f"out_dir={out}", "device=cpu",
                       "optim.epochs=1"]
        train.main(argv)
        folder = train.parse_overrides(argv).xp_folder
        history = json.loads((folder / "history-torch.json").read_text())
        assert len(history) == 1 and set(history[0]["test"]) == {key}
        assert np.isfinite(history[0]["train"]["loss"])
        assert (folder / "done-torch.json").exists()
        value = history[0]["test"][key]
        assert np.isfinite(value) and (key != "acc_WordSegment"
                                       or 0 <= value <= 1)
