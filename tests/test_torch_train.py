"""The PyTorch port's training slice against the JAX package on the same
numpy inputs and bridged weights: the merger's dropout disk and usage
penalty, the CLIP and masked losses, the weight bridge of fused_conv_bn
models, Adam, and three whole training steps of Trainer against the JAX
solver's jitted step, with fused_conv_bn off and on, and with the
clip_conv_tpu recipe's structural options in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_solver import tiny_args

from brainmagick_tpu import losses as jlosses
from brainmagick_tpu import train as bm_train
from brainmagick_tpu.convert import _untransform
from brainmagick_tpu.dataset import SegmentBatch
from brainmagick_tpu.env import env
from brainmagick_tpu.models import common as jcommon
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu_torch import convert, losses
from brainmagick_tpu_torch.config import MainConfig
from brainmagick_tpu_torch.models import common
from brainmagick_tpu_torch.models.simpleconv import SimpleConv
from brainmagick_tpu_torch.train import Trainer, build_optimizer, model_hash

INVALID = common.INVALID_POSITION
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _bct(x_btc):
    return np.swapaxes(np.asarray(x_btc), 1, 2)


def _merger_case():
    rng = np.random.RandomState(1)
    B, C, T, R = 4, 12, 20, 3
    meg = rng.randn(B, C, T).astype(np.float32)
    rec_positions = rng.rand(R, C, 2).astype(np.float32)
    rec_positions[1, 9:] = INVALID
    return meg, rec_positions, np.array([0, 1, 2, 1])


@pytest.mark.parametrize("per_recording", [True, False],
                         ids=["per_recording", "per_sample"])
def test_channel_merger_dropout_matches_jax(monkeypatch, per_recording):
    """Train mode with a dropout disk: the centre the JAX module drew
    (recorded from jax.random.uniform) passed to the port gives the same
    output (atol 1e-5) and usage penalty. Recording 2's sensors all lie in
    the disk, so the all-masked guard must act after the disk."""
    drawn = []
    uniform = jax.random.uniform

    def record(*args, **kwargs):
        out = uniform(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out
    monkeypatch.setattr(jax.random, "uniform", record)

    meg, rec_positions, rec_index = _merger_case()
    jm = jcommon.ChannelMerger(8, pos_dim=32, dropout=0.3, usage_penalty=0.5)
    subjects = jnp.zeros(4, jnp.int32)
    meg_btc = jnp.asarray(np.swapaxes(meg, 1, 2))

    def run(variables, rec_positions):
        positions = jnp.asarray(rec_positions[rec_index])
        kwargs = {}
        if per_recording:
            kwargs = dict(pos_emb=jcommon.fourier_emb(
                jnp.asarray(rec_positions), 32),
                rec_index=jnp.asarray(rec_index),
                rec_positions=jnp.asarray(rec_positions))
        if variables is None:
            return jm.init(jax.random.PRNGKey(0), meg_btc, positions,
                           subjects, **kwargs)
        return jm.apply(variables, meg_btc, positions, subjects, train=True,
                        rngs={"dropout": jax.random.PRNGKey(5)},
                        mutable=["losses"], **kwargs), kwargs

    variables = run(None, rec_positions)
    run(variables, rec_positions)
    center = drawn[-1]
    # recording 2: every sensor within 0.05 of the centre the key draws
    rec_positions[2] = center + 0.05 * (
        np.random.RandomState(2).rand(12, 2).astype(np.float32) - 0.5)
    (want, sown), kwargs = run(variables, rec_positions)
    np.testing.assert_array_equal(drawn[-1], center)

    port = common.ChannelMerger(8, pos_dim=32, dropout=0.3,
                                usage_penalty=0.5).train()
    convert.load_by_rules(port, [("heads", ("heads",), "copy", "params")],
                          variables["params"], {})
    weights = port.attention(
        _t(rec_positions[rec_index]), center=_t(center),
        **{k: _t(np.asarray(v)) for k, v in kwargs.items()})
    got = torch.einsum("bct,boc->bot", _t(meg), weights)
    np.testing.assert_allclose(got.detach().numpy(), _bct(want), atol=1e-5)
    # sample 2 (recording 2, every sensor in the disk): the guard leaves
    # a finite softmax of the raw scores
    assert torch.isfinite(weights).all()
    np.testing.assert_allclose(weights[2].sum(-1).detach().numpy(), 1.,
                               rtol=1e-6)
    np.testing.assert_allclose(port.penalty(weights).item(),
                               float(sown["losses"]["penalty"][0]),
                               rtol=1e-6)


def test_channel_merger_dropout_generator():
    """Without a centre, the disk comes from the explicit generator: the
    same seed gives the same attention, another seed another; without
    either, train mode raises; eval mode ignores the disk."""
    meg, rec_positions, rec_index = _merger_case()
    port = common.ChannelMerger(8, pos_dim=32, dropout=0.3)
    port.reset_parameters(torch.Generator().manual_seed(0))
    positions = _t(rec_positions[rec_index])
    port.train()
    a, b, c = (port.attention(positions, generator=torch.Generator()
                              .manual_seed(seed)) for seed in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        port.attention(positions)
    port.eval()
    assert torch.equal(port.attention(positions),
                       port.attention(positions, center=_t([0.5, 0.5])))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_clip_loss_matches_jax(train):
    """ClipLoss.__call__ with sample and candidate weights (a rejected
    in-batch sample and a masked extra negative) and, in training, the
    tmin_train/tmax_train window: the loss (rtol 1e-6) and its gradient
    in the estimates (rtol/atol 1e-6) against JAX."""
    rng = np.random.RandomState(0)
    est = rng.randn(4, 6, 10).astype(np.float32)
    cand = rng.randn(6, 6, 10).astype(np.float32)
    sw = np.array([1, 0, 1, 1], np.float32)
    cw = np.array([1, 0, 1, 1, 1, 0], np.float32)
    kw = dict(tmin_train=-0.4, tmax_train=-0.1, dset_tmin=-0.5,
              dset_sample_rate=20.)
    jl = jlosses.ClipLoss(**kw)

    def jloss(e):
        return jl.apply({"params": {}}, e, jnp.asarray(cand),
                        sample_weight=jnp.asarray(sw),
                        candidate_weight=jnp.asarray(cw), train=train)
    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(est))
    et = _t(est, grad=True)
    got = losses.ClipLoss(**kw)(et, _t(cand), sample_weight=_t(sw),
                                candidate_weight=_t(cw), train=train)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)
    # the trimmed window leaves samples without gradient in training
    assert bool((et.grad == 0).all(dim=0).all(dim=0).any()) == train
    scores = _t(rng.randn(3, 5).astype(np.float32))
    np.testing.assert_allclose(
        losses.ClipLoss.loss_from_scores(scores).item(),
        float(jlosses.ClipLoss.loss_from_scores(jnp.asarray(scores.numpy()))),
        rtol=1e-6)


@pytest.mark.parametrize("name", ["masked_l1", "masked_l2"])
def test_masked_losses_match_jax(name):
    rng = np.random.RandomState(1)
    est, out = (rng.randn(3, 4, 5).astype(np.float32) for _ in range(2))
    mask = rng.rand(3, 1, 5) > 0.3
    sw = np.array([1, 0, 1], np.float32)
    for weight in (None, sw):
        want = getattr(jlosses, name)(
            jnp.asarray(est), jnp.asarray(out), jnp.asarray(mask),
            None if weight is None else jnp.asarray(weight))
        got = getattr(losses, name)(
            _t(est), _t(out), _t(mask),
            None if weight is None else _t(weight))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


#: tests/test_solver.py tiny_args simpleconv, at a 20-sensor input
TINY = dict(hidden=24, depth=3, kernel_size=3, dilation_period=2, skip=True,
            glu=2, glu_context=1, merger=True, merger_channels=16,
            merger_pos_dim=32, initial_linear=16, gelu=True,
            batch_norm=True, subject_layers=True, subject_dim=0,
            complex_out=True)


def test_bridge_of_fused_models():
    """A JAX fused_conv_bn=true tree loads with every leaf consumed, and
    the eval forward then matches the JAX module (rtol/atol 1e-4); a stray
    leaf, or a fused tree into an unfused model, raises."""
    kw = {**TINY, "hidden": {"meg": 24}, "fused_conv_bn": True}
    kw.update(in_channels={"meg": 20}, out_channels=8, n_subjects=2)
    jmodel, port = JaxSimpleConv(**kw), SimpleConv(**kw).eval()
    rng = np.random.RandomState(5)
    meg = rng.randn(3, 20, 40).astype(np.float32)
    positions = rng.rand(3, 20, 2).astype(np.float32)
    subjects = np.array([0, 1, 1], np.int32)
    variables = jmodel.init(jax.random.PRNGKey(0), {"meg": jnp.asarray(meg)},
                            jnp.asarray(subjects), jnp.asarray(positions))
    params = {"model": jax.device_get(variables["params"])}
    stats = {"model": jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        jax.device_get(variables["batch_stats"]))}
    assert "FusedConvBN_2" in params["model"]["encoder_meg"]
    convert.load_jax_params(port, params, stats)
    want = jmodel.apply({"params": params["model"],
                         "batch_stats": stats["model"]},
                        {"meg": jnp.asarray(meg)}, jnp.asarray(subjects),
                        jnp.asarray(positions))
    with torch.no_grad():
        got = port({"meg": _t(meg)}, _t(subjects).long(), _t(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    stray = {"model": {**params["model"],
                       "Stray_0": {"kernel": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="Stray_0"):
        convert.load_jax_params(port, stray, stats)
    unfused = SimpleConv(**{**kw, "fused_conv_bn": False})
    with pytest.raises(KeyError):
        convert.load_jax_params(unfused, params, stats)


def test_adam_matches_optax_and_model_hash():
    """build_optimizer's update equals optax.adam's over 3 steps (rtol
    1e-6); model_hash is a function of the weights."""
    args = MainConfig()
    args.optim.lr, args.optim.beta2 = 1e-2, 0.99
    rng = np.random.RandomState(0)
    w0 = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) * 10 ** -k for k in range(3)]
    param = torch.nn.Parameter(_t(w0))
    opt = build_optimizer(args, [param])
    tx = optax.adam(args.optim.lr, b1=0.9, b2=args.optim.beta2)
    w, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for g in grads:
        param.grad = _t(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, updates)
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(w),
                               rtol=1e-6, atol=1e-7)
    args.optim.name = "sgd"
    with pytest.raises(ValueError, match="sgd"):
        build_optimizer(args, [param])
    a, b = (torch.nn.Linear(3, 2) for _ in range(2))
    b.load_state_dict(a.state_dict())
    assert model_hash(a) == model_hash(b)
    with torch.no_grad():
        b.bias.add_(1)
    assert model_hash(a) != model_hash(b)


#: the solvers' model options beyond tiny_args: fused_conv_bn off and on,
#: and the clip_conv_tpu recipe's structural options (no conv bias before
#: BatchNorm, the fused head with per-recording subjects, tanh GELU) in
#: fp32 on the port's fused train path
VARIANTS = {"unfused": dict(), "fused": dict(fused_conv_bn=True),
            "recipe": dict(fused_conv_bn=True, bn_conv_bias=False,
                           fused_head=True, gelu_exact=False)}


@pytest.fixture(scope="module")
def jax_solvers(tmp_path_factory):
    """Untrained tiny_args JAX solvers with an Adam optimizer and no
    merger dropout, one per VARIANTS entry."""
    tmp = tmp_path_factory.mktemp("train")
    cache = tmp / "fake_cache"
    cache.mkdir()
    solvers = {}
    with env.temporary(cache=cache):
        for name, options in VARIANTS.items():
            args = tiny_args(cache, tmp / name)
            args.simpleconv.update(merger_dropout=0., **options)
            solvers[name] = bm_train.get_solver(args, training=True)
        yield solvers


def _batches(solver):
    """STEPS batches of 6 items, 3 from each training recording."""
    dsets = solver.datasets.train.datasets
    return [SegmentBatch.collate([d[i] for d in dsets
                                  for i in range(3 * s, 3 * s + 3)])
            for s in range(STEPS)]


def _trainer(solver):
    state = jax.device_get(solver.state)
    return Trainer(solver.args, solver.model.in_channels["meg"],
                   solver.model.out_channels, solver.model.n_subjects,
                   state["params"], state["batch_stats"],
                   {k: np.asarray(v) for k, v in solver.norm_arrays.items()},
                   device="cpu", generator=torch.Generator().manual_seed(0))


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return np.asarray(tree)


def _noise_driven(model, tkey):
    """Entries whose gradient is mathematically zero: the conv bias in
    front of an unfused BatchNorm (the normalization cancels it), and the
    merger heads along the constant Fourier feature (column 0, cos 0 = 1:
    the softmax over sensors ignores a constant score). Their gradient is
    float noise, and Adam turns a noise gradient of either sign into a
    step of about lr."""
    shape = model.get_parameter(tkey).shape
    mask = np.zeros(shape, bool)
    if tkey == "merger.heads":
        mask[:, 0] = True
    parts = tkey.split(".")
    if parts[-1] == "bias" and parts[-3:-1] == [parts[-3], "0"] \
            and "sequence" in parts:
        layer = model.get_submodule(".".join(parts[:-2]))
        mask[:] = isinstance(layer[1], torch.nn.BatchNorm1d)
    return mask


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_match_jax_solver(jax_solvers, variant):
    """Three Trainer.steps against the JAX solver's jitted
    _build_step(True, False, False) on the same batches:

    - the loss of every step, rtol 1e-5 (float32 sums in other orders);
    - keep and count exactly;
    - the first step's gradient of every parameter against jax.grad of
      the solver's loss, atol 1e-5 (entries reach 0.8; observed 1.3e-6);
    - every parameter after the steps within 0.01 lr, except the
      noise-driven entries (``_noise_driven``), within Adam's bound of
      2 lr per step (each side moves at most about lr per step);
    - the running variances, rtol 1e-5, and the running means, atol
      1e-5 fused and, unfused, 2 STEPS lr (1 - 0.99^STEPS): the running
      mean takes in that share of the noise-driven conv bias's drift.
    """
    solver = jax_solvers[variant]
    fused = variant != "unfused"
    trainer = _trainer(solver)
    assert trainer.model.encoders["meg"].fused == [fused] * 2
    # the recipe's fused head engages: the solver hands it rec_subjects
    assert ("rec_subjects" in trainer.solver.norm_arrays) \
        and trainer.model.fused_head == (variant == "recipe")
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
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=1e-5)
        assert got["keep"].item() == float(want["keep"])
        assert got["count"].item() == float(want["count"]) == len(batch)
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
            atol = 1e-5 if fused else 2 * STEPS * lr * (1 - 0.99 ** STEPS)
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=tkey)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_step_matches_jax_solver(jax_solvers, variant):
    """train=False: the eval-mode loss with no update (rtol 1e-5), and the
    weights untouched."""
    solver = jax_solvers[variant]
    trainer = _trainer(solver)
    before = model_hash(trainer.model)
    batch = _batches(solver)[0]
    _, want = solver._build_step(False, False, False)(
        solver.state, batch.to_device(), solver.norm_arrays,
        jnp.ones(len(batch), jnp.float32), None, None, jax.random.PRNGKey(0))
    got = trainer.step(batch, train=False)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    assert model_hash(trainer.model) == before
    assert all(p.grad is None for p in trainer.model.parameters())
