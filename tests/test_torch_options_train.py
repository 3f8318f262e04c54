"""The train step's options in the PyTorch port against the JAX package:
the SVD penalty (its matrices, value and gradients, given the JAX
package's starting blocks), the negative pool's sampling and update,
ClipLoss's learned projection (``clip.linear``, ``twin``) and its
``est_layout``, three Trainer steps with ``clip.linear`` and
``optim.svd`` against the JAX solver's jitted step, the checkpoint's
``loss.`` parameters, and ``output_layout="btc"`` in a solver step.

Tolerances: the penalty and its gradients 1e-5 of their largest
magnitude (the gradients flow through QR and the SVD); the pool bit for
bit; the projection's scores, loss and gradients 1e-5; the train steps
tests/test_torch_train.py's (losses rtol 1e-5, the first step's
gradients atol 1e-5, the parameters within 0.01 lr)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args
from test_torch_convrnn import _flax_variables
from test_torch_recipe import TINY, _max_err
from test_torch_train import _batches, _leaf, _noise_driven

from brainmagick_tpu import losses as jlosses
from brainmagick_tpu import svd as jsvd
from brainmagick_tpu import train as bm_train
from brainmagick_tpu.config import MainConfig as JaxConfig
from brainmagick_tpu.env import env
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu.solver import Solver as JaxSolver
from brainmagick_tpu_torch import convert, losses, svd
from brainmagick_tpu_torch import train as port_train
from brainmagick_tpu_torch.convert import _untransform
from brainmagick_tpu_torch.env import env as port_env
from brainmagick_tpu_torch.models.simpleconv import SimpleConv
from brainmagick_tpu_torch.solver import target_length
from brainmagick_tpu_torch.train import Trainer

#: the penalty, its gradients, the projection: max |port - JAX| over the
#: largest magnitude
TOL = 1e-5
STEPS = 3
#: a first gradient below this is float noise to Adam (100 eps)
NOISE_FLOOR = 1e-6
#: SimpleConv's layer options, whose 1x1 kernels join the penalty
LAYER = dict(rewrite=True, scale=0.1, post_skip=True)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


class _Always:
    """The JAX solver's stand-in RNG that always applies the penalty."""

    def random(self) -> float:
        return 0.


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_starts(model):
    """The starting blocks the JAX penalty draws for `model`'s matrices:
    ``jax.random.normal(PRNGKey(1234 + k), (n, min(16, n)))`` in the
    matrix's type."""
    shapes = [(w[0].numel(), min(16, w[0].numel()))
              for w in svd.iter_weight_matrices(model)]
    dtype = jnp.float64 if next(model.parameters()).dtype == torch.float64 \
        else jnp.float32
    # one compile for all the draws
    return [np.asarray(q) for q in jax.jit(lambda: [
        jax.random.normal(jax.random.PRNGKey(1234 + k), shape, dtype)
        for k, shape in enumerate(shapes)])()]


def _svd_case(fused=False):
    """A port SimpleConv of tests/test_torch_recipe.py's TINY with the
    layer options and 16 outputs, seeded, and its flax tree (the port's
    weights through its rules, the leaves and shapes of the flax module's
    init): every kernel matrix has at least the 16 rows of the penalty's
    starting block (see ``test_svd_penalty_matches_jax``)."""
    kw = {**TINY, **LAYER, "out_channels": 16, "fused_conv_bn": fused}
    port = SimpleConv(**kw)
    rng = np.random.RandomState(5)
    shapes = jax.eval_shape(
        JaxSimpleConv(**kw).init, jax.random.PRNGKey(0),
        {"meg": jnp.zeros((3, 20, 40))}, jnp.zeros(3, jnp.int32),
        jnp.asarray(rng.rand(3, 20, 2).astype(np.float32)))
    variables = _flax_variables(port, convert.simpleconv_rules(port), {
        coll: {"model": tree} for coll, tree in shapes.items()}, 5)
    return port, variables["params"]["model"]


def _jax_penalty(exact):
    """The JAX package's penalty and its gradient, jitted (its starting
    blocks drawn inside, as the JAX step draws them)."""
    return jax.jit(jax.value_and_grad(lambda p: jsvd.svd_penalty(
        p, exact=exact, _rng=_Always())))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_svd_matrices_are_the_jax_packages(fused):
    """``iter_weight_matrices`` of a seeded tiny SimpleConv with the layer
    options gives the JAX package's matrices of the same flax tree, in
    its order and layout, bit for bit: the convs' kernels (the 24-element
    post-skip kernels under the 2^8-element threshold left out), the
    head's transposed conv, no merger heads, subject matrices or
    LayerScale; with the threshold down, the post-skip kernels too."""
    port, params = _svd_case(fused)
    for min_size in (1., 0.05):
        want = [np.asarray(w) for w in
                jsvd.iter_weight_matrices(params, min_size)]
        got = [w.detach().numpy()
               for w in svd.iter_weight_matrices(port, min_size)]
        assert len(got) == len(want) >= (8 if min_size == 1. else 9)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(want) > len(list(svd.iter_weight_matrices(port)))


@pytest.mark.parametrize("exact", [False, True], ids=["randomized", "exact"])
def test_svd_penalty_matches_jax(exact):
    """The penalty against the JAX package's on the same tree, randomized
    from the JAX package's own starting blocks (``_jax_starts``, the
    draws of its ``PRNGKey(1234 + k)``) or exact against
    ``jnp.linalg.svd``: the fp32 value within TOL, and in float64 (both
    packages' functions without fp32's rounding) the value and the
    gradient in every weight within TOL of their largest magnitude, the
    weights that are no kernel without gradient. The randomized gradient
    of a matrix with fewer rows than its 16 starting columns has no
    gradient to speak of in either package (the QR of a rank-deficient
    block divides by its vanishing diagonal: with 8 outputs the head's
    gradients differ by their own size even in float64), so the model has
    16 outputs, as a real target's 120 mel bins or 1,024 wav2vec 2.0
    features give more."""
    port, jparams = _svd_case()
    for dtype in (np.float32, np.float64):
        model = copy.deepcopy(port).to(torch.float64 if dtype == np.float64
                                       else torch.float32)
        with jax.enable_x64(dtype == np.float64):
            params = jax.tree_util.tree_map(lambda v: np.asarray(v, dtype),
                                            jparams)
            want, grads = _jax_penalty(exact)(params)
            want, grads = float(want), jax.device_get(grads)
            starts = None if exact else [_t(q) for q in _jax_starts(model)]
        got = svd.svd_penalty(model, exact=exact, rng=_Always(),
                              starts=starts)
        assert abs(got.item() - want) <= TOL * abs(want), dtype
        if dtype == np.float32:
            continue
        got.backward()
        for tkey, fpath, kind, coll in convert.simpleconv_rules(model):
            if coll != "params":
                continue
            grad = model.get_parameter(tkey).grad
            want_grad = _untransform(kind, np.asarray(
                _leaf({"model": grads}, fpath), np.float64))
            if fpath[-1] == "kernel" and np.abs(want_grad).max() > 0:
                assert _max_err(grad, want_grad) <= TOL, tkey
            else:
                assert grad is None and not want_grad.any(), tkey


def test_svd_penalty_rules():
    """The default starting blocks are fixed (two calls give the same
    penalty, torch's global generator untouched), ``proba`` skips through
    its RNG and rescales what it keeps."""
    port, _ = _svd_case()
    state = torch.get_rng_state()
    a, b = (svd.svd_penalty(port) for _ in range(2))
    assert torch.equal(a, b) and torch.equal(torch.get_rng_state(), state)

    class Fixed:
        def __init__(self, value):
            self.value = value

        def random(self):
            return self.value
    assert svd.svd_penalty(port, proba=0.5, rng=Fixed(0.7)).item() == 0
    np.testing.assert_allclose(
        svd.svd_penalty(port, proba=0.5, rng=Fixed(0.3)).item(),
        2 * a.item(), rtol=1e-6)


def test_negative_pool_matches_the_jax_solver():
    """``_sample_negatives`` and ``_update_negative_pool`` against the JAX
    solver's on the same targets, step after step, bit for bit: the
    negatives drawn (zero rows of weight 0 while the pool is short), the
    pool newest first cut to 2 x negatives, the pool size resolved
    without writing into args."""
    jargs = JaxConfig()
    jargs.optim.loss, jargs.optim.negatives = "clip", 12
    jargs.task.offset_meg_ms = 50
    js = object.__new__(JaxSolver)
    js.args, js.feature_model, js.mesh = jargs, None, None
    js.negative_pool = {"train": None, "valid": None}
    js.negative_pool_size = 2 * jargs.optim.negatives
    args = port_train.parse_overrides(
        ["preset=tiny", "optim.loss=clip", "optim.negatives=12",
         "task.offset_meg_ms=50", "device=cpu"])
    trainer = Trainer(args, 20, 8, 2, None, None, dict(
        meg_center=np.zeros((1, 20), np.float32),
        meg_scale=np.ones((1, 20), np.float32),
        feat_center=np.zeros(8, np.float32),
        feat_scale=np.ones(8, np.float32),
        rec_positions=np.random.RandomState(0).rand(1, 20, 2).astype(
            np.float32)), "cpu")
    solver = trainer.solver
    assert solver.negative_pool_size == 24 and args.optim.negative_pool_size \
        is None
    seed = (args.seed * 9176 + 3 * 2) % 2 ** 31
    js._neg_rng, solver._neg_rng = (np.random.RandomState(seed)
                                    for _ in range(2))
    assert solver._effective_candidates(8) == js._effective_candidates(8)
    rng = np.random.RandomState(1)
    feat_shape = (8, 8, 145)
    for step in range(5):
        got = [x.numpy() for x in solver._sample_negatives(
            "train", feat_shape, 12, 8)]
        want = [np.asarray(x) for x in js._sample_negatives(
            "train", feat_shape, 12, 8)]
        assert got[0].shape == (4, 8, 139)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[1].sum() == (0 if step == 0 else 4)
        outputs = rng.randn(8, 8, 139).astype(np.float32)
        js._update_negative_pool("train", outputs)
        solver._update_negative_pool("train", _t(outputs))
        np.testing.assert_array_equal(solver.negative_pool["train"],
                                      js.negative_pool["train"])
    assert len(solver.negative_pool["train"]) == 24


@pytest.mark.parametrize("twin, layout", [(True, "bct"), (False, "bct"),
                                          (True, "btc")],
                         ids=["twin", "linear_gt", "btc"])
def test_clip_loss_projection_matches_flax(twin, layout):
    """ClipLoss with a learned projection over the trimmed time axis
    (through one Dense, or ``linear_gt`` for the candidates without
    `twin`), from flax's tree bridged by ``clip_loss_rules``, and with
    ``est_layout`` "btc" on [B, T, F] estimates: the scores, the train
    loss with sample and candidate weights, and its gradients in the
    estimates and in every projection parameter, each within TOL."""
    rng = np.random.RandomState(0)
    est = rng.randn(4, 6, 20).astype(np.float32)
    cand = rng.randn(6, 6, 20).astype(np.float32)
    sw = np.array([1, 0, 1, 1], np.float32)
    cw = np.array([1, 0, 1, 1, 1, 0], np.float32)
    kw = dict(linear=5, twin=twin, tmin=-0.3, tmax=0.4, dset_tmin=-0.5,
              dset_sample_rate=20., est_layout=layout)
    est_in = np.swapaxes(est, 1, 2).copy() if layout == "btc" else est
    jl = jlosses.ClipLoss(**kw)
    params = jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.asarray(
        est_in), jnp.asarray(cand), method=jl.get_scores))["params"]
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.randn(*v.shape).astype(np.float32), params)
    assert sorted(params) == (["linear_est"] if twin
                              else ["linear_est", "linear_gt"])

    def jloss(p, e):
        return jl.apply({"params": p}, e, jnp.asarray(cand),
                        sample_weight=jnp.asarray(sw),
                        candidate_weight=jnp.asarray(cw), train=True)
    want, (pgrads, egrad) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1)))(params, jnp.asarray(est_in))
    want_scores = jl.apply({"params": params}, jnp.asarray(est_in),
                           jnp.asarray(cand), method=jl.get_scores)

    port = losses.ClipLoss(**kw, length=20)
    rules = convert.clip_loss_rules(port)
    convert.load_by_rules(port, rules, {"loss": params}, {})
    et = _t(est_in).requires_grad_(True)
    got = port(et, _t(cand), sample_weight=_t(sw), candidate_weight=_t(cw),
               train=True)
    got.backward()
    assert _max_err(port.get_scores(et, _t(cand)), want_scores) <= TOL
    assert abs(got.item() - float(want)) <= TOL * abs(float(want))
    assert _max_err(et.grad, egrad) <= TOL
    for tkey, fpath, kind, _ in rules:
        assert _max_err(port.get_parameter(tkey).grad, _untransform(
            kind, _leaf({"loss": pgrads}, fpath))) <= TOL, tkey
    with pytest.raises(ValueError, match="length"):
        losses.ClipLoss(linear=5)


def test_zero_negatives_keep_the_projection_finite():
    """The zero-weight zero rows that pad the sampled negatives, through
    the projection at its zero initial bias: the port's gradients stay
    finite (an all-zero candidate's norm has gradient 0), where the JAX
    package's are NaN (its square root at 0); the loss is the same."""
    rng = np.random.RandomState(2)
    est = rng.randn(2, 3, 10).astype(np.float32)
    cand = np.concatenate([est + 0.1, np.zeros((2, 3, 10), np.float32)])
    weight = np.array([1, 1, 0, 0], np.float32)
    jl = jlosses.ClipLoss(linear=4)
    params = jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.asarray(est),
                                    jnp.asarray(cand),
                                    method=jl.get_scores))["params"]
    want, grads = jax.jit(jax.value_and_grad(lambda p: jl.apply(
        {"params": p}, jnp.asarray(est), jnp.asarray(cand),
        sample_weight=jnp.ones(2), candidate_weight=jnp.asarray(weight),
        train=True)))(params)
    assert np.isnan(grads["linear_est"]["kernel"]).any()
    port = losses.ClipLoss(linear=4, length=10)
    convert.load_by_rules(port, convert.clip_loss_rules(port),
                          {"loss": params}, {})
    got = port(_t(est), _t(cand), sample_weight=torch.ones(2),
               candidate_weight=_t(weight), train=True)
    got.backward()
    assert abs(got.item() - float(want)) <= TOL * abs(float(want))
    assert all(torch.isfinite(p.grad).all() for p in port.parameters())


@pytest.fixture(scope="module")
def linear_solver(tmp_path_factory):
    """The JAX package's tiny_args solver over 16 mel bins with a
    twin-less projection of 8, the SVD penalty, the layer options and
    fused conv_stats (no merger dropout), its cache folder and a folder of
    its own."""
    tmp = tmp_path_factory.mktemp("options")
    cache = tmp / "fake_cache"
    cache.mkdir()
    with env.temporary(cache=cache):
        args = tiny_args(cache, tmp / "jax")
        args.simpleconv.update(merger_dropout=0., fused_conv_bn=True,
                               **LAYER)
        args.clip.linear, args.clip.twin = 8, False
        # the penalty at a weight where its gradient is well conditioned:
        # at 0.1 it leads the kernels' gradients, and the 1e-5 moves that
        # Adam's first step leaves between the packages (in the entries
        # of noise-level gradient) move the second step's kernel
        # gradients by 2.7e-4 of their size (at 0.01-0.03 under 1e-5);
        # both packages compute one penalty (test_svd_penalty_matches_jax)
        args.optim.svd = 0.03
        # 16 mel bins: the head's matrix has the 16 rows the penalty's
        # gradient needs (see test_svd_penalty_matches_jax)
        args.dset.features_params = {"MelSpectrum": {"n_mels": 16}}
        init = JaxSimpleConv.init

        def jitted_init(model, rngs, *inputs, **kwargs):
            # one compile, where flax's unjitted init compiles each draw
            return jax.jit(lambda r, *x: init(model, r, *x, **kwargs))(
                rngs, *inputs)
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(JaxSimpleConv, "init", jitted_init)
            solver = bm_train.get_solver(args, training=True)
    return solver, cache, tmp


def _linear_trainer(solver, **overrides):
    state = jax.device_get(solver.state)
    args = copy.deepcopy(solver.args)
    for key, value in overrides.items():
        args.simpleconv[key] = value
    batch = _batches(solver)[0]
    return Trainer(args, solver.model.in_channels["meg"],
                   solver.model.out_channels, solver.model.n_subjects,
                   state["params"], state["batch_stats"],
                   {k: np.asarray(v) for k, v in solver.norm_arrays.items()},
                   device="cpu", generator=torch.Generator().manual_seed(0),
                   length=target_length(args, batch.features.shape[-1]))


def test_linear_and_svd_steps_match_jax_solver(linear_solver, monkeypatch):
    """Three Trainer.steps with clip.linear (twin off), optim.svd and the
    layer options against the JAX solver's jitted step on the same
    batches, the SVD starting blocks the JAX step's: the loss of every
    step rtol 1e-5, the first step's gradient of every parameter (the
    projection's included) atol 1e-5, and every parameter after the steps
    within 0.01 lr. Within 2 lr a step: tests/test_torch_train.py's
    noise-driven entries, and those whose first gradient lies at the
    float noise floor (below NOISE_FLOOR, 100 times Adam's eps), where
    Adam's first update lr g / (|g| + eps) turns that noise into a step
    of up to lr."""
    solver = linear_solver[0]
    trainer = _linear_trainer(solver)
    starts = [_t(q) for q in _jax_starts(trainer.model)]
    monkeypatch.setattr(svd, "start_block",
                        lambda k, n, dim, dtype, device: starts[k])
    assert trainer.clip_loss.linear_gt is not None
    params_of = {id(p) for g in trainer.optimizer.param_groups
                 for p in g["params"]}
    assert {id(p) for p in trainer.clip_loss.parameters()} <= params_of
    step = solver._build_step(True, False, False)
    # strong types throughout (LayerScale's initial leaf is weak): one
    # compile of the step
    state = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)),
                                   solver.state)
    rng = jax.random.PRNGKey(0)
    rules = convert.simpleconv_rules(trainer.model)
    loss_rules = convert.clip_loss_rules(trainer.clip_loss)
    modules = [(trainer.model, rules), (trainer.clip_loss, loss_rules)]
    for i, batch in enumerate(_batches(solver)):
        arrays = batch.to_device()
        pad = jnp.ones(len(batch), jnp.float32)
        if i == 0:
            grads = jax.device_get(jax.jit(jax.grad(
                lambda p: solver._loss_and_aux(
                    p, state["batch_stats"], arrays, solver.norm_arrays, pad,
                    None, None, rng, True, False)[0]))(state["params"]))
        state, want = step(state, arrays, solver.norm_arrays, pad, None,
                           None, rng)
        got = trainer.step(batch)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-5)
        if i == 0:
            first = {}
            for module, module_rules in modules:
                for tkey, fpath, kind, coll in module_rules:
                    if coll == "params":
                        first[tkey] = module.get_parameter(tkey).grad.numpy()
                        np.testing.assert_allclose(
                            first[tkey],
                            _untransform(kind, _leaf(grads, fpath)),
                            rtol=0, atol=1e-5, err_msg=tkey)
    lr = solver.args.optim.lr
    state = jax.device_get(state)
    for module, module_rules in modules:
        for tkey, fpath, kind, coll in module_rules:
            if coll != "params":
                continue
            want = _untransform(kind, _leaf(state[coll], fpath))
            got = module.get_parameter(tkey).detach().numpy()
            noisy = np.abs(first[tkey]) < NOISE_FLOOR
            if module is trainer.model:
                noisy = noisy | _noise_driven(module, tkey)
            atol = np.where(noisy, 2 * STEPS * lr, 0.01 * lr)
            assert (np.abs(got - want) <= atol).all(), tkey


def test_btc_solver_step_equals_bct(linear_solver):
    """A solver with ``output_layout="btc"`` transposes the estimate back
    at the model's boundary: its train step's loss and gradients equal the
    "bct" solver's on the same weights and batch."""
    solver = linear_solver[0]
    batch = _batches(solver)[0]
    results = []
    for layout in ("bct", "btc"):
        trainer = _linear_trainer(solver, output_layout=layout)
        loss = trainer.step(batch)["loss"].item()
        results.append((loss, {k: p.grad.clone() for k, p in
                               trainer.model.named_parameters()
                               if p.grad is not None}))
    (a, ga), (b, gb) = results
    assert a == b and ga.keys() == gb.keys()
    for key in ga:
        assert torch.equal(ga[key], gb[key]), key


def test_checkpoint_keeps_the_projection(linear_solver):
    """The port's CLI solver of the same XP with the projection: the best
    state and the checkpoint carry the loss's parameters under
    ``loss.``, Adam updates them, a fresh solver restores them, and a
    solver built for evaluation (``training=False``) loads the best
    state's projection."""
    _, cache, tmp = linear_solver
    args = port_train.parse_overrides(
        ['dset.selections=["fake"]', "dset.n_recordings=2",
         'dset.features=["MelSpectrum"]',
         'dset.features_params={"MelSpectrum": {"n_mels": 8}}',
         "dset.condition=1.0", "dset.tmin=-0.2", "dset.tmax=1.0",
         "dset.test_ratio=0.3", "dset.valid_ratio=0.2",
         "dset.min_n_blocks_per_split=1", "optim.loss=clip",
         "optim.batch_size=8", "preset=tiny", "clip.linear=8",
         "optim.negatives=12", "optim.max_batches=2", "optim.epochs=1",
         "device=cpu", "num_workers=0", f"cache={cache}",
         f"out_dir={tmp / 'port'}"])
    with port_env.temporary(cache=cache):
        solver = port_train.get_solver(args)
        before = solver.clip_loss.linear_est.weight.detach().clone()
        solver._run_one_epoch(True)
        solver._run_one_epoch(False)
        assert solver.negative_pool["train"].shape[0] == 16
        assert not torch.equal(solver.clip_loss.linear_est.weight, before)
        assert "loss.linear_est.weight" in solver.best_state
        solver.commit()
        weight = solver.clip_loss.linear_est.weight.detach().clone()
        best = solver.best_state["loss.linear_est.weight"]
        resumed = port_train.get_solver(args)
        assert torch.equal(resumed.clip_loss.linear_est.weight, weight)
        np.testing.assert_array_equal(resumed.negative_pool["train"],
                                      solver.negative_pool["train"])
        evaluated = port_train.get_solver(args, training=False)
        assert torch.equal(evaluated.clip_loss.linear_est.weight, best)
