"""Table 2's "MelSpectrum + DeepMel" cell in the port against the JAX
package, on the CPU: the DeepMel module on bridged weights in eval and
train mode, the cell's train step against the JAX solver's jitted step
(the model's and the feature model's gradients and parameters), its
epochs through ``Solver.train``, and the checkpoint's round trip through
``play.get_solver_from_sig`` with the feature model in the best state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args
from test_torch_epochs import LOSS_RTOL, _port_args
from test_torch_train import STEPS, _batches, _leaf
from test_torch_train import _noise_driven as _model_noise_driven

from brainmagick_tpu import train as jtrain
from brainmagick_tpu.convert import _untransform
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.models.features import DeepMel as JaxDeepMel
from brainmagick_tpu_torch import convert, models, play, train
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.models.features import DeepMel
from brainmagick_tpu_torch.solver import FM_PREFIX

#: a small DeepMel: 16 hidden channels x 3 layers, 24 outputs
SMALL = dict(n_hidden_channels=16, n_hidden_layers=3, n_out_channels=24)
#: the cell on tests/test_solver.py's tiny_args, without merger dropout
CELL = ["preset=deep_mel", "simpleconv.merger_dropout=0.0",
        *(f"feature_model_params.{k}={v}" for k, v in SMALL.items())]
#: outputs and running statistics of the module: fp32 convs summed in
#: other orders (observed below 1e-6)
FM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _module_pair(n_in=8, **options):
    """The flax DeepMel with seeded BatchNorm running statistics and the
    port's on its weights."""
    kw = dict(SMALL, **options)
    jfm = JaxDeepMel(n_in_channels=n_in, **kw)
    x = np.random.RandomState(0).randn(4, n_in, 30).astype(np.float32)
    variables = jax.device_get(jfm.init(jax.random.PRNGKey(0), x))
    rng = np.random.RandomState(1)

    def draw(path, leaf):
        if path[-1].key == "mean":
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        draw, variables["batch_stats"])
    port = DeepMel(n_in_channels=n_in, **kw)
    convert.load_by_rules(port, convert.deepmel_rules(port),
                          {"fm": variables["params"]},
                          {"fm": variables["batch_stats"]})
    return jfm, variables, port, x


@pytest.mark.parametrize("options", [{}, dict(skip=False, glu=1)], ids=str)
def test_deepmel_matches_jax(options):
    """Eval mode: the outputs within FM_TOL. Train mode: the outputs and
    every BatchNorm's updated running mean and variance within FM_TOL.
    Both fp32, [B, F, T] in and out."""
    jfm, variables, port, x = _module_pair(**options)
    want = np.asarray(jfm.apply(variables, x, train=False))
    got = port.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 24, 30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FM_TOL)

    want, mutated = jfm.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=FM_TOL)
    stats = jax.device_get(mutated["batch_stats"])
    rules = [r for r in convert.deepmel_rules(port) if r[3] == "batch_stats"]
    assert rules
    for tkey, fpath, _, _ in rules:
        np.testing.assert_allclose(port.get_buffer(tkey).numpy(),
                                   _leaf(stats, fpath[1:]), rtol=0,
                                   atol=FM_TOL, err_msg=tkey)


def test_build_feature_model():
    """``models.build_feature_model``: None without a feature model, the
    preset's DeepMel (320 x 10 -> 768) over the features' width, and
    ValueError for another name, as the JAX package's build_model."""
    args = train.parse_overrides([])
    assert models.build_feature_model(args, 8, "cpu") is None
    args = train.parse_overrides(["preset=tiny", "preset=deep_mel"])
    fm = models.build_feature_model(args, 8, "cpu")
    assert isinstance(fm, DeepMel) and not fm.training
    assert (fm.n_in_channels, fm.n_hidden_channels, fm.n_hidden_layers,
            fm.n_out_channels) == (8, 320, 10, 768)
    assert models.build_model(args, 20, 8, 2, "cpu").out_channels == 768
    args.feature_model_name = "deep_wav"
    with pytest.raises(ValueError, match="deep_wav"):
        models.build_feature_model(args, 8, "cpu")


@pytest.fixture(scope="module")
def jax_solver(tmp_path_factory):
    """The JAX solver of the cell (two epochs), with Adam, and its
    initial state."""
    tmp = tmp_path_factory.mktemp("deepmel")
    cache = tmp / "fake_cache"
    cache.mkdir()
    args = jtrain.parse_overrides(CELL, tiny_args(cache, tmp))
    with jenv.temporary(cache=cache):
        solver = jtrain.get_solver(args, training=True)
        yield solver, jax.device_get(solver.state), cache


def _noise_driven(module, tkey):
    """Entries whose gradient is mathematically zero, as a mask: the
    model's (tests/test_torch_train.py), and the feature model's conv
    biases in front of a BatchNorm (the normalization cancels them).
    Their gradient is float noise, and Adam turns it into a step of about
    lr of either sign."""
    if not isinstance(module, DeepMel):
        return _model_noise_driven(module, tkey)
    parts = tkey.split(".")
    layer = module.get_submodule(".".join(parts[:2]))
    return np.full(module.get_parameter(tkey).shape,
                   parts[-1] == "bias" and len(layer) > 1
                   and isinstance(layer[1], torch.nn.BatchNorm1d))


def test_train_steps_match_jax_solver(jax_solver):
    """Three steps of ``train.Trainer`` against the JAX solver's jitted
    step on the same batches and weights, as in
    tests/test_torch_train.py: losses rtol 1e-5, keep and count exactly,
    the first step's gradient of every parameter of the model and of the
    feature model atol 1e-5, every parameter after the steps within
    0.01 lr (the noise-driven entries, ``_noise_driven``, within Adam's
    2 lr a step), the running variances rtol 1e-5 and the running means within
    the share of those biases' drift they take in."""
    solver, state0, _ = jax_solver
    chout = solver.feature_model.n_in_channels
    trainer = train.Trainer(
        solver.args, solver.model.in_channels["meg"], chout,
        solver.model.n_subjects, state0["params"], state0["batch_stats"],
        {k: np.asarray(v) for k, v in solver.norm_arrays.items()},
        device="cpu", generator=torch.Generator().manual_seed(0))
    assert trainer.model.out_channels == SMALL["n_out_channels"]
    assert isinstance(trainer.feature_model, DeepMel)
    n_params = sum(p.numel() for p in trainer.model.parameters()) \
        + sum(p.numel() for p in trainer.feature_model.parameters())
    assert sum(p.numel() for group in trainer.optimizer.param_groups
               for p in group["params"]) == n_params
    step = solver._build_step(True, False, False)
    state = jax.tree_util.tree_map(jnp.array, state0)
    rng = jax.random.PRNGKey(0)
    modules = [(trainer.model, convert.simpleconv_rules(trainer.model)),
               (trainer.feature_model,
                convert.deepmel_rules(trainer.feature_model))]
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
            for module, rules in modules:
                for tkey, fpath, kind, coll in rules:
                    if coll == "params":
                        np.testing.assert_allclose(
                            module.get_parameter(tkey).grad.numpy(),
                            _untransform(kind, _leaf(grads, fpath)),
                            rtol=0, atol=1e-5, err_msg=tkey)

    lr = solver.args.optim.lr
    state = jax.device_get(state)
    for module, rules in modules:
        for tkey, fpath, kind, coll in rules:
            want = _untransform(kind, _leaf(state[coll], fpath))
            if coll == "params":
                got = module.get_parameter(tkey).detach().numpy()
                atol = np.where(_noise_driven(module, tkey), 2 * STEPS * lr,
                                0.01 * lr)
                assert (np.abs(got - want) <= atol).all(), tkey
            elif tkey.endswith("running_var"):
                np.testing.assert_allclose(module.get_buffer(tkey).numpy(),
                                           want, rtol=1e-5, err_msg=tkey)
            else:
                np.testing.assert_allclose(
                    module.get_buffer(tkey).numpy(), want, rtol=0,
                    atol=2 * STEPS * lr * (1 - 0.99 ** STEPS), err_msg=tkey)


def test_epochs_match_jax_solver_and_checkpoint_round_trips(jax_solver):
    """Two epochs of ``Solver.train`` on the fake study against the JAX
    solver's from the same weights: each epoch's train and valid losses
    within LOSS_RTOL, the same best epoch, a test stage with the WER
    keys. Then the XP by its signature (``play.get_solver_from_sig``,
    the port's checkpoint-torch.pt beside the JAX package's
    checkpoint.pkl): its best state holds the feature model's weights
    and running statistics, and both models carry the best state."""
    jsolver, state0, cache = jax_solver
    args = _port_args(cache, jsolver.args.out_dir, "optim.epochs=2", *CELL)
    assert args.xp_folder == jsolver.args.xp_folder
    # the port's solver is built before the JAX run writes its
    # checkpoint.pkl, which a port training run in the folder resumes
    with env.temporary(cache=cache):
        solver = train.get_solver(args)
        convert.load_jax_params(solver.model, state0["params"],
                                state0["batch_stats"], solver.feature_model)
    assert solver.history == [] and solver.epoch == 1
    with jenv.temporary(cache=cache):
        jsolver.train()
    with env.temporary(cache=cache):
        solver.train()
    assert len(solver.history) == len(jsolver.history) == 2
    assert [sorted(h) for h in solver.history] \
        == [sorted(h) for h in jsolver.history]
    for got, want in zip(solver.history, jsolver.history):
        for stage in ("train", "valid"):
            print(f"deep_mel {stage} loss: port {got[stage]['loss']:.6f}, "
                  f"jax {want[stage]['loss']:.6f}")
            np.testing.assert_allclose(got[stage]["loss"],
                                       want[stage]["loss"], rtol=LOSS_RTOL)
    assert solver.best_epoch == jsolver.best_epoch
    assert {"wer", "wer_vocab", "wer_n_vocab"} <= set(solver.history[0]
                                                       ["test"])

    with env.temporary(cache=cache):
        restored = play.get_solver_from_sig(
            args.sig, out_dir=args.out_dir, override_args={"device": "cpu"})
    best = solver.best_state
    assert set(restored.best_state) == set(best)
    fm_keys = [k for k in best if k.startswith(FM_PREFIX)]
    assert {k[len(FM_PREFIX):] for k in fm_keys} \
        == set(solver.feature_model.state_dict())
    for key, value in best.items():
        assert torch.equal(restored.best_state[key], value), key
    loaded = {**restored.model.state_dict(),
              **{FM_PREFIX + k: v for k, v in
                 restored.feature_model.state_dict().items()}}
    for key, value in best.items():
        assert torch.equal(loaded[key], value), key
    assert restored.optimizer is None
