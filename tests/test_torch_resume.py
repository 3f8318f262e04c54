"""Resuming training across the two packages through the JAX package's
``checkpoint.pkl``: the JAX solver trains two steps and commits; the port
resumes it (weights, best state, counters, and optax's Adam moments
mapped onto ``torch.optim.Adam``, each moment exactly the transformed
array) and its next steps match the JAX package's own resumed steps; the
JAX package resumes a ``checkpoint.pkl`` the port wrote (optax's class
names as the JAX package pickles them) and its steps match the port's;
``continue_sig`` onto a JAX XP; ``play.get_solver_from_sig(training=True)``
on a JAX-only XP; and the bridge's inverse direction (every transform,
the flax trees' layout, the refusals)."""

import copy
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args
from test_torch_bridge import BASE
from test_torch_epochs import TINY
from test_torch_train import _noise_driven

from brainmagick_tpu import train as jtrain
from brainmagick_tpu.convert import _untransform as jax_untransform
from brainmagick_tpu.dataset import SegmentBatch
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.models.features import DeepMel as JaxDeepMel
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu_torch import convert, play, train
from brainmagick_tpu_torch.dataset import to_device
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.models.features import DeepMel
from brainmagick_tpu_torch.models.simpleconv import SimpleConv
from brainmagick_tpu_torch.solver import prepare_norm_arrays

#: steps before the checkpoint, and after it
STEPS, MORE = 2, 2
#: the resumed steps' losses against the other package's, relative
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _batches(solver, n):
    """`n` batches of 6 items, 3 from each training recording."""
    dsets = solver.datasets.train.datasets
    return [SegmentBatch.collate([d[i] for d in dsets
                                  for i in range(3 * s, 3 * s + 3)])
            for s in range(n)]


def _jax_steps(solver, state, batches):
    """The JAX solver's jitted train step over `batches` from `state`:
    (state, losses)."""
    step = solver._build_step(True, False, False)
    losses = []
    for batch in batches:
        pad = jnp.ones(len(batch), jnp.float32)
        state, metrics = step(state, batch.to_device(), solver.norm_arrays,
                              pad, None, None, jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    return state, losses


def _port_steps(solver, batches):
    losses = []
    for batch in batches:
        metrics = solver.step(to_device(batch, "cpu"),
                              torch.ones(len(batch)), True)
        losses.append(metrics["loss"].item())
    return losses


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return np.asarray(tree)


def _port_args(cache, out_dir, *extra):
    return train.parse_overrides(
        TINY + [f"cache={cache}", f"out_dir={out_dir}", "device=cpu",
                "optim.epochs=2", "simpleconv.merger_dropout=0.0", *extra])


def _port_solver(run, out_dir, *extra, **kwargs):
    """The port's solver of the XP (restoring what its folder holds) on
    the JAX solver's normalization arrays, so that both packages step on
    the same inputs."""
    with env.temporary(cache=run.cache):
        solver = train.get_solver(_port_args(run.cache, out_dir, *extra),
                                  **kwargs)
    solver.norm_arrays = prepare_norm_arrays(
        solver.model, {k: None if v is None else np.asarray(v)
                       for k, v in run.jax.norm_arrays.items()}, "cpu")
    return solver


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """tests/test_solver.py's tiny_args without merger dropout: the JAX
    solver trains STEPS steps, takes the weights after the first as its
    best state, and commits (``checkpoint.pkl``); then the JAX package
    resumes that file in a fresh solver and takes MORE steps."""
    root = tmp_path_factory.mktemp("resume")
    cache = root / "fake_cache"
    cache.mkdir()
    jargs = tiny_args(cache, root / "jax")
    jargs.simpleconv.update(merger_dropout=0.)
    with jenv.temporary(cache=cache), env.temporary(cache=cache):
        jsolver = jtrain.get_solver(jargs, training=True)
        batches = _batches(jsolver, STEPS + MORE)
        state, _ = _jax_steps(jsolver, jsolver.state, batches[:1])
        best = jax.device_get({"params": state["params"],
                               "batch_stats": state["batch_stats"]})
        state, losses = _jax_steps(jsolver, state, batches[1:STEPS])
        jsolver.state = state
        jsolver.best_state, jsolver.best_loss, jsolver.best_epoch = (
            best, 1.25, 1)
        jsolver.history = [{"train": {"loss": 2.5}, "valid": {"loss": 1.25}}]
        jsolver.commit(block=True)
        resumed = jtrain.get_solver(jargs, training=True)
        after, jax_losses = _jax_steps(resumed, resumed.state,
                                       batches[STEPS:])
        yield types.SimpleNamespace(
            cache=cache, root=root, jargs=jargs, jax=jsolver,
            batches=batches, saved=jax.device_get(state), best=best,
            resumed=jax.device_get(after), resumed_losses=jax_losses,
            lr=jargs.optim.lr)


def _check_weights(model, trees, exact=True, lr=None, steps=0):
    """`model`'s weights and running statistics against the flax trees:
    bit for bit, or after `steps` steps of each package within 0.01 lr
    (the noise-driven entries within Adam's 2 lr a step) and the running
    statistics as tests/test_torch_train.py holds them."""
    for tkey, fpath, kind, coll in convert.simpleconv_rules(model):
        want = jax_untransform(kind, _leaf(trees[coll], fpath))
        if coll == "params":
            got = model.get_parameter(tkey).detach().numpy()
            atol = 0 if exact else np.where(_noise_driven(model, tkey),
                                            2 * steps * lr, 0.01 * lr)
            assert (np.abs(got - want) <= atol).all(), tkey
        else:
            got = model.get_buffer(tkey).numpy()
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=tkey)
            elif tkey.endswith("running_var"):
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           err_msg=tkey)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0, err_msg=tkey,
                    atol=2 * steps * lr * (1 - 0.99 ** steps))


def _check_moments(solver, opt_state):
    """The optimizer's moments are the transformed optax moments, bit for
    bit, and every parameter's step is optax's count."""
    adam = opt_state[0]
    count, mu, nu = adam.count, adam.mu, adam.nu
    rules = convert.simpleconv_rules(solver.model)
    for tkey, fpath, kind, coll in rules:
        if coll != "params":
            continue
        st = solver.optimizer.state[solver.model.get_parameter(tkey)]
        assert st["step"].dtype == torch.float32
        assert st["step"].item() == int(count) == STEPS
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            np.testing.assert_array_equal(
                st[key].numpy(), jax_untransform(kind, _leaf(tree, fpath)),
                err_msg=f"{key} {tkey}")
    n_params = sum(1 for _ in train.trained_parameters(
        solver.model, solver.feature_model, solver.clip_loss))
    assert len(solver.optimizer.state) == n_params


def test_port_resumes_the_jax_checkpoint(run):
    """A port training run in the JAX XP's folder (``checkpoint.pkl``
    only): the JAX state's weights and statistics, its best state, history
    and counters, and Adam's moments, each exactly; then MORE steps on the
    batches the JAX package's resumed solver took: losses within
    LOSS_RTOL, weights within 0.01 lr."""
    solver = _port_solver(run, run.root / "jax" / "outputs")
    assert solver.args.xp_folder == run.jargs.xp_folder
    _check_weights(solver.model, run.saved)
    with open(solver.folder / "checkpoint.pkl", "rb") as f:
        payload = pickle.load(f)
    _check_moments(solver, payload["state"]["opt_state"])
    read = convert.load_jax_checkpoint(solver.folder / "checkpoint.pkl")
    best = copy.deepcopy(solver.model)
    convert.load_jax_params(best, run.best["params"],
                            run.best["batch_stats"])
    for key, value in best.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(solver.best_state[key], value), key
    assert (solver.epoch, solver.best_epoch, solver.best_loss,
            solver.history) == (read["epoch"], 1, 1.25, read["history"])
    losses = _port_steps(solver, run.batches[STEPS:])
    print(f"resumed losses: port {losses}, jax {run.resumed_losses}")
    np.testing.assert_allclose(losses, run.resumed_losses, rtol=LOSS_RTOL)
    _check_weights(solver.model, run.resumed, exact=False, lr=run.lr,
                   steps=MORE)


class _Recorder(convert._JaxCheckpointUnpickler):
    """The checkpoint reader, noting each (module, name) it is asked for."""

    def __init__(self, f):
        super().__init__(f)
        self.names = set()

    def find_class(self, module, name):
        self.names.add((module, name))
        return super().find_class(module, name)


def _class_names(path):
    with open(path, "rb") as f:
        reader = _Recorder(f)
        reader.load()
    return reader.names


def test_jax_package_resumes_a_port_checkpoint(run):
    """The port resumes the JAX XP, steps MORE times, and writes its state
    with ``save_jax_checkpoint`` into another XP folder: the file names
    optax's classes as the JAX package's own checkpoint does, the JAX
    package restores it (weights, moments and count exactly the port's),
    and MORE more steps of each package on the same batches agree within
    LOSS_RTOL and 0.01 lr."""
    solver = _port_solver(run, run.root / "jax" / "outputs")
    _port_steps(solver, run.batches[STEPS:])
    jargs = tiny_args(run.cache, run.root / "reverse")
    jargs.simpleconv.update(merger_dropout=0.)
    jargs.xp_folder.mkdir(parents=True)
    path = convert.save_jax_checkpoint(solver,
                                       jargs.xp_folder / "checkpoint.pkl")
    names = _class_names(path)
    jax_names = _class_names(run.jax.checkpoint_path)
    optax = {n for n in jax_names if n[0].startswith("optax")}
    assert optax == {convert.OPTAX_ADAM_STATE, convert.OPTAX_EMPTY_STATE}
    assert {n for n in names if n[0].startswith("optax")} == optax
    assert names <= jax_names
    with jenv.temporary(cache=run.cache):
        jsolver = jtrain.get_solver(jargs, training=True)
    assert type(jsolver.state["opt_state"][0]).__name__ == "ScaleByAdamState"
    assert int(jsolver.state["opt_state"][0].count) == STEPS + MORE
    assert int(jsolver.state["step"]) == STEPS + MORE
    assert jsolver.epoch == solver.epoch + 1
    state = jax.device_get(jsolver.state)
    _check_weights(solver.model, state)
    exported = convert.export_jax_optimizer_state(
        solver.optimizer, solver.model, solver.feature_model,
        solver.clip_loss)[0][0]
    for index, name in ((1, "mu"), (2, "nu")):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               getattr(state["opt_state"][0], name),
                               exported[index])
    after, jax_losses = _jax_steps(jsolver, jsolver.state,
                                   run.batches[:MORE])
    after = jax.device_get(after)
    losses = _port_steps(solver, run.batches[:MORE])
    print(f"steps after the port's checkpoint: port {losses}, "
          f"jax {jax_losses}")
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    _check_weights(solver.model, after, exact=False, lr=run.lr, steps=MORE)


@pytest.mark.parametrize("continue_best", [True, False])
def test_continue_sig_onto_a_jax_xp(run, continue_best):
    """Another XP with ``continue_sig`` naming the JAX XP: what the JAX
    package loads, its best state with ``continue_best`` and else its
    current weights and statistics, bit for bit, with a fresh optimizer,
    history and counters."""
    sig = run.jargs.sig
    solver = _port_solver(run, run.root / "jax" / "outputs",
                          "optim.epochs=3", f"continue_sig={sig}",
                          f"continue_best={continue_best}")
    assert solver.args.sig != sig
    _check_weights(solver.model, run.best if continue_best else run.saved)
    assert len(solver.optimizer.state) == 0
    assert (solver.epoch, solver.history, solver.best_state) == (1, [], None)


def test_get_solver_from_sig_resumes_training(run):
    """``play.get_solver_from_sig(training=True)`` on the JAX-only XP: a
    solver with Adam's moments, the JAX state's weights and its best
    state, ready to train on."""
    solver = play.get_solver_from_sig(
        run.jargs.sig, out_dir=str(run.root / "jax" / "outputs"),
        training=True, override_args={"device": "cpu"})
    assert solver.optimizer is not None
    _check_weights(solver.model, run.saved)
    with open(solver.folder / "checkpoint.pkl", "rb") as f:
        _check_moments(solver, pickle.load(f)["state"]["opt_state"])
    evaluation = play.get_solver_from_sig(
        run.jargs.sig, out_dir=str(run.root / "jax" / "outputs"),
        override_args={"device": "cpu"})
    assert evaluation.optimizer is None
    _check_weights(evaluation.model, run.best)


#: bridge option sets the inverse direction runs over (BASE of
#: tests/test_torch_bridge.py), with a DeepMel
EXPORT_CASES = {
    "base": (dict(), False), "fused": (dict(fused_conv_bn=True), False),
    "layer": (dict(rewrite=True, scale=0.1, post_skip=True,
                   bn_conv_bias=False), False),
    "per_subject": (dict(merger_per_subject=True), False),
    "deep_mel": (dict(), True)}


@pytest.mark.parametrize("case", list(EXPORT_CASES))
def test_export_inverts_the_bridge(case):
    """``export_jax_params`` gives trees with the flax init's leaves and
    shapes, and ``load_jax_params`` of them rebuilds every weight and
    running statistic bit for bit; every transform inverts exactly."""
    options, with_fm = EXPORT_CASES[case]
    kw = {"in_channels": {"meg": 20}, "out_channels": 8, "n_subjects": 2,
          **BASE, **options}
    gen = torch.Generator().manual_seed(3)
    model = SimpleConv(**kw)
    for value in model.state_dict().values():
        if value.is_floating_point():
            value.copy_(torch.randn(value.shape, generator=gen))
    fm = DeepMel(n_in_channels=8, n_hidden_channels=16, n_hidden_layers=3,
                 n_out_channels=8) if with_fm else None
    params, stats = convert.export_jax_params(model, fm)
    meg = jnp.zeros((2, 20, 30))
    variables = jax.eval_shape(
        lambda: JaxSimpleConv(**kw).init(
            jax.random.PRNGKey(0), {"meg": meg}, jnp.zeros(2, jnp.int32),
            jnp.zeros((2, 20, 2))))
    shapes = jax.tree_util.tree_map(lambda x: x.shape, variables)
    assert jax.tree_util.tree_map(np.shape, params["model"]) \
        == shapes["params"]
    assert jax.tree_util.tree_map(np.shape, stats["model"]) \
        == shapes.get("batch_stats", {})
    assert params["loss"] == {} and ("fm" in params) == with_fm
    if with_fm:
        fm_vars = jax.eval_shape(lambda: JaxDeepMel(
            n_in_channels=8, n_hidden_channels=16, n_hidden_layers=3,
            n_out_channels=8).init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, 8, 30)), train=False))
        assert jax.tree_util.tree_map(np.shape, params["fm"]) \
            == jax.tree_util.tree_map(lambda x: x.shape, fm_vars["params"])
    fresh = SimpleConv(**kw)
    fresh_fm = None if fm is None else DeepMel(
        n_in_channels=8, n_hidden_channels=16, n_hidden_layers=3,
        n_out_channels=8)
    convert.load_jax_params(fresh, params, stats, fresh_fm)
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[key], value), key
    rng = np.random.RandomState(0)
    for kind in ("copy", "conv_w", "dense_w", "convT_w", "convT_w_as_conv"):
        x = rng.randn(*((5, 3) if kind == "dense_w" else (4, 3, 5))
                      ).astype(np.float32)
        np.testing.assert_array_equal(
            convert._untransform(kind, convert._transform(kind, x)), x)
        if kind != "dense_w":           # the JAX package's rules have none
            np.testing.assert_array_equal(
                convert._transform(kind, jax_untransform(kind, x)), x)


def test_the_bridge_refuses_what_it_cannot_map():
    """A weight no rule maps cannot be exported; a moment no parameter
    takes, or a parameter without moments, cannot be loaded; a state that
    is not optax.adam's is refused."""
    kw = {"in_channels": {"meg": 20}, "out_channels": 8, "n_subjects": 2,
          **BASE}
    model = SimpleConv(**kw)
    opt = torch.optim.Adam(model.parameters())
    params, _ = convert.export_jax_params(model)
    (adam, empty), count = convert.export_jax_optimizer_state(opt, model)
    assert count == 0 and len(empty) == 0
    convert.load_jax_optimizer_state(opt, (adam, empty), model)
    assert all(st["step"].item() == 0 for st in opt.state.values())
    stray_mu = {**adam[1], "model": {**adam[1]["model"],
                                     "Stray_0": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="Stray_0"):
        convert.load_jax_optimizer_state(
            opt, ((adam[0], stray_mu, adam[2]), empty), model)
    with pytest.raises(ValueError, match="optax.adam"):
        convert.load_jax_optimizer_state(opt, (adam,), model)
    extra = torch.nn.Parameter(torch.zeros(3))
    opt.add_param_group({"params": [extra]})
    with pytest.raises(ValueError, match="no moments"):
        convert.load_jax_optimizer_state(opt, (adam, empty), model)
    model.register_parameter("stray", extra)
    with pytest.raises(NotImplementedError, match="stray"):
        convert.export_jax_params(model)
