"""The clip_conv_tpu recipe in the PyTorch port against the JAX package, on
the same numpy inputs and bridged weights: the preset's knobs, and in bf16
(``simpleconv.dtype``) each module that casts (the conv stack in eval and
train mode with and without fused_conv_bn, the merger, the fused head),
the whole SimpleConv, and the serving forward and three training steps of
Server and Trainer against the JAX solver; in fp32, the fused head against
the unfused ops and a batch whose subject overrides its recording's.

Where the two frameworks round to bf16 at other places (a conv's bias
added before or after its rounding, XLA's fused elementwise chains), the
outputs differ by a few bf16 roundings: each tolerance below says how
many."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args

from brainmagick_tpu import config as jconfig
from brainmagick_tpu import train as bm_train
from brainmagick_tpu.convert import _untransform
from brainmagick_tpu.dataset import SegmentBatch
from brainmagick_tpu.env import env
from brainmagick_tpu.models import common as jcommon
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu_torch import config, convert
from brainmagick_tpu_torch.models import common
from brainmagick_tpu_torch.models.simpleconv import SimpleConv
from brainmagick_tpu_torch.serve import Server
from brainmagick_tpu_torch.train import Trainer

#: the recipe's model options beyond clip_conv: structural, then bf16
STRUCTURE = dict(bn_conv_bias=False, fused_head=True, gelu_exact=False)
BF16 = dict(dtype="bfloat16", output_dtype="bfloat16")
#: one module in bf16: the error's largest entry over the output's largest
#: magnitude, 4 bf16 roundings (2^-8 each) where the frameworks round at
#: other places
MODULE_TOL = 4 * 2 ** -8
#: a bias-free conv, the merger and the fused head in bf16, where both
#: frameworks round the same operands and the same fp32 accumulator: they
#: agree up to the accumulation's order (1e-7 here). The same module in
#: fp32 misses JAX's bf16 by the operands' roundings, past CAST_MISS.
CAST_TOL = 2 ** -16
CAST_MISS = 2 ** -10
#: a whole bf16 forward or step: the error's norm over the output's norm
RECIPE_TOL = 2 ** -5
#: a bias's bf16 gradient, a sum of B T cancelling cotangent terms: XLA's
#: backward of the broadcast add sums them in bf16 on the CPU, where torch
#: sums in fp32, so the JAX side carries that sum's rounding
BIAS_GRAD_TOL = 2 ** -3
STEPS = 3
INVALID = common.INVALID_POSITION


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    """A tensor or JAX array of any float type as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bct(x_btc):
    return np.swapaxes(_np(x_btc), 1, 2)


def _max_err(got, want):
    """max |got - want| over max |want|."""
    return np.abs(_np(got) - _np(want)).max() / np.abs(_np(want)).max()


def _norm_err(got, want):
    """|got - want| over |want| (Frobenius)."""
    return np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(_np(want))


def test_preset_is_clip_conv_plus_the_recipe():
    """clip_conv_tpu is clip_conv with the STRUCTURE and BF16 model
    options, bf16 scores and the bf16 wire, in the port's copy as in the
    JAX package."""
    for module in (config, jconfig):
        base = module.apply_preset(module.MainConfig(), "clip_conv")
        tpu = module.apply_preset(module.MainConfig(), "clip_conv_tpu")
        delta = {k: v for k, v in tpu.simpleconv.items()
                 if base.simpleconv.get(k) != v}
        assert delta == {**STRUCTURE, **BF16}
        assert tpu.clip.compute_dtype == "bfloat16"
        assert tpu.parallel.transfer_dtype == "bfloat16"
        assert tpu.parallel.assemble_dtype == "bfloat16"


#: a conv stack with GLU gates, dilation period 2, tanh GELU and no conv
#: bias before BatchNorm, as the recipe's encoder
SEQ = dict(channels=(16, 16, 16, 16), kernel=3, dilation_growth=2,
           dilation_period=2, skip=True, batch_norm=True, glu=2,
           glu_context=1)


def _seq_pair(fused):
    jseq = jcommon.ConvSequence(
        stride=1, activation=jcommon.get_activation(True, gelu_exact=False),
        fused_conv_bn=fused, bn_conv_bias=False, dtype=jnp.bfloat16, **SEQ)
    port = common.ConvSequence(
        activation=common.get_activation(True, gelu_exact=False),
        fused_conv_bn=fused, bn_conv_bias=False,
        compute_dtype=torch.bfloat16, **SEQ)
    x = np.random.RandomState(0).randn(3, 16, 40).astype(np.float32)
    variables = jax.device_get(jseq.init(jax.random.PRNGKey(0),
                                         jnp.asarray(np.swapaxes(x, 1, 2))))
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: ((rng.randn(*v.shape) * 0.1) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    rules = convert.conv_sequence_rules(port, "", ())
    convert.load_by_rules(port, rules, variables["params"], stats)
    return jseq, port, variables["params"], stats, rules, x


@pytest.mark.parametrize("train, fused", [(False, False), (True, False),
                                          (True, True)],
                         ids=["eval", "train", "train_fused"])
def test_conv_sequence_bf16_matches_jax(train, fused):
    """The conv stack with compute dtype bf16 on a bf16 input: the output
    (bf16) within MODULE_TOL; in train mode (BatchNorm on batch
    statistics, through conv_stats when fused) each parameter's gradient
    through sum(out^2) within RECIPE_TOL in norm, and the running
    statistics (fp32, from bf16 convs) within MODULE_TOL."""
    jseq, port, params, stats, rules, x = _seq_pair(fused)
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(np.swapaxes(xb.float().numpy(), 1, 2)).astype(
        jnp.bfloat16)

    def jloss(p):
        out, mut = jseq.apply({"params": p, "batch_stats": stats}, xj,
                              train=train, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) ** 2), (out, mut)

    (_, (want, mutated)), grads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    out = port.train(train)(xb)
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _max_err(out, _bct(want)) <= MODULE_TOL
    if not train:
        return
    (out.float() ** 2).sum().backward()
    tensors = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    for tkey, fpath, kind, coll in rules:
        node = grads if coll == "params" else mutated["batch_stats"]
        for part in fpath:
            node = node[part]
        want_leaf = _untransform(kind, np.asarray(node))
        if coll == "params":
            assert _norm_err(tensors[tkey].grad, want_leaf) <= RECIPE_TOL, \
                tkey
        else:
            assert _max_err(tensors[tkey], want_leaf) <= MODULE_TOL, tkey


def _merger_inputs():
    rng = np.random.RandomState(1)
    B, C, T, R = 4, 12, 20, 3
    meg = rng.randn(B, C, T).astype(np.float32)
    rec_positions = rng.rand(R, C, 2).astype(np.float32)
    rec_positions[1, 9:] = INVALID
    rec_positions[2] = INVALID
    return meg, rec_positions, np.array([0, 1, 1, 0])


@pytest.mark.parametrize("per_recording", [True, False],
                         ids=["per_recording", "per_sample"])
def test_channel_merger_bf16_matches_jax(per_recording):
    """A bf16 meg: the scores contract in bf16 with an fp32 accumulator,
    the softmax is fp32, and the mix returns fp32 (not a bf16 rounding of
    it), within CAST_TOL."""
    meg, rec_positions, rec_index = _merger_inputs()
    megb = torch.from_numpy(meg).bfloat16()
    meg_btc = jnp.asarray(np.swapaxes(megb.float().numpy(), 1, 2)).astype(
        jnp.bfloat16)
    positions = rec_positions[rec_index]
    jkw, kw = {}, {}
    if per_recording:
        pos_emb = jcommon.fourier_emb(jnp.asarray(rec_positions), 32)
        jkw = dict(pos_emb=pos_emb, rec_index=jnp.asarray(rec_index),
                   rec_positions=jnp.asarray(rec_positions))
        kw = dict(pos_emb=_t(pos_emb), rec_index=_t(rec_index),
                  rec_positions=_t(rec_positions))
    jm = jcommon.ChannelMerger(8, pos_dim=32)
    subjects = jnp.zeros(4, jnp.int32)
    variables = jm.init(jax.random.PRNGKey(0), meg_btc,
                        jnp.asarray(positions), subjects, **jkw)
    want = jm.apply(variables, meg_btc, jnp.asarray(positions), subjects,
                    **jkw)
    port = common.ChannelMerger(8, pos_dim=32)
    convert.load_by_rules(port, [("heads", ("heads",), "copy", "params")],
                          variables["params"], {})
    got = port(megb, _t(positions), **kw)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _max_err(got, _bct(want)) <= CAST_TOL


#: tests/test_solver.py tiny_args simpleconv, at a 20-sensor input
TINY = dict(hidden={"meg": 24}, depth=2, kernel_size=3, dilation_period=2,
            skip=True, glu=2, glu_context=1, merger=True, merger_channels=16,
            merger_pos_dim=32, initial_linear=16, gelu=True,
            batch_norm=True, subject_layers=True, subject_dim=0,
            complex_out=True, in_channels={"meg": 20}, out_channels=8,
            n_subjects=3)


def _model_case(**options):
    """A JAX and a port SimpleConv with TINY and `options`, the JAX
    variables (seeded running statistics) bridged into the port, and the
    per-recording inputs: recordings 0 and 1 of subjects 2 and 0, sample 2
    of recording 1 given subject 1 (the batch's own pair overrides the
    table, as the solvers do)."""
    jmodel = JaxSimpleConv(**TINY, **options)
    port = SimpleConv(**TINY, **options).eval()
    rng = np.random.RandomState(5)
    B, C, T = 3, 20, 40
    meg = rng.randn(B, C, T).astype(np.float32)
    rec_positions = rng.rand(2, C, 2).astype(np.float32)
    rec_positions[1, 15:] = INVALID
    rec_index = np.array([0, 1, 1])
    subjects = np.array([2, 0, 0], np.int32)
    rec_subjects = np.array([2, 1], np.int32)          # recording 1: subject 1
    positions = rec_positions[rec_index]
    pos_emb = jcommon.fourier_emb(jnp.asarray(rec_positions), 32)
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), {"meg": jnp.asarray(meg)},
        jnp.asarray(subjects), jnp.asarray(positions)))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: ((rng.randn(*v.shape) * 0.1) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    convert.load_jax_params(port, {"model": variables["params"]},
                            {"model": stats})
    jargs = ({"meg": jnp.asarray(meg)}, jnp.asarray(subjects),
             jnp.asarray(positions))
    jkw = dict(pos_emb=pos_emb, rec_index=jnp.asarray(rec_index),
               rec_positions=jnp.asarray(rec_positions),
               rec_subjects=jnp.asarray(rec_subjects))
    args = ({"meg": _t(meg)}, _t(subjects).long(), _t(positions))
    kw = dict(pos_emb=_t(pos_emb), rec_index=_t(rec_index),
              rec_positions=_t(rec_positions),
              rec_subjects=_t(rec_subjects).long())
    variables = {"params": variables["params"], "batch_stats": stats}
    return jmodel, port, variables, (jargs, jkw), (args, kw)


def _encoder_inputs(jmodel, port, variables, jcall, call):
    """The head's output on both sides: what each encoder receives."""
    seen = {}

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, jcommon.ConvSequence):
            seen["jax"] = args[0]
        return next_fun(*args, **kwargs)
    with jax.default_device(jax.devices("cpu")[0]):
        import flax.linen as fnn
        with fnn.intercept_methods(intercept):
            jmodel.apply(variables, *jcall[0], **jcall[1])
    handle = port.encoders["meg"].register_forward_pre_hook(
        lambda module, inputs: seen.__setitem__("port", inputs[0]))
    with torch.no_grad():
        port(*call[0], **call[1])
    handle.remove()
    return seen["port"], np.swapaxes(_np(seen["jax"]), 1, 2)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_fused_head_matches_jax(dtype):
    """The fused head's output (what the encoder receives, fp32 on both
    sides) against the flax module's _fused_head, sample 2's subject
    taken from the overridden rec_subjects: rtol/atol 1e-4 in fp32,
    CAST_TOL in bf16."""
    jmodel, port, variables, jcall, call = _model_case(
        fused_head=True, dtype=dtype)
    got, want = _encoder_inputs(jmodel, port, variables, jcall, call)
    assert got.dtype == torch.float32
    if dtype is None:
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)
    else:
        assert _max_err(got, want) <= CAST_TOL


def _cast_case(module, dtype):
    """`module` of the port with compute dtype `dtype` (None: fp32) and the
    flax module in bf16, on the same bf16 input: (port's output, JAX's),
    [B, C, T]."""
    if module == "fused_head":
        jmodel, port, variables, jcall, call = _model_case(
            fused_head=True, dtype="bfloat16")
        if dtype is None:
            _, port, _, _, _ = _model_case(fused_head=True)
        return _encoder_inputs(jmodel, port, variables, jcall, call)
    if module == "merger":
        meg, rec_positions, rec_index = _merger_inputs()
        positions = rec_positions[rec_index]
        pos_emb = jcommon.fourier_emb(jnp.asarray(rec_positions), 32)
        jkw = dict(pos_emb=pos_emb, rec_index=jnp.asarray(rec_index),
                   rec_positions=jnp.asarray(rec_positions))
        kw = dict(pos_emb=_t(pos_emb), rec_index=_t(rec_index),
                  rec_positions=_t(rec_positions))
        jm, port = jcommon.ChannelMerger(8, pos_dim=32), None
    else:
        # the recipe's BatchNorm'd convs: no bias, dilated
        meg = np.random.RandomState(0).randn(3, 16, 40).astype(np.float32)
        jm = fnn.Conv(24, (3,), padding=[(2, 2)], kernel_dilation=(2,),
                      use_bias=False, dtype=jnp.bfloat16)
        kw, jkw = {}, {}
    megb = torch.from_numpy(meg).bfloat16()
    meg_btc = jnp.asarray(np.swapaxes(megb.float().numpy(), 1, 2)).astype(
        jnp.bfloat16)
    if module == "merger":
        jargs = (meg_btc, jnp.asarray(positions), jnp.zeros(4, jnp.int32))
        variables = jm.init(jax.random.PRNGKey(0), *jargs, **jkw)
        port = common.ChannelMerger(8, pos_dim=32)
        convert.load_by_rules(port, [("heads", ("heads",), "copy",
                                      "params")], variables["params"], {})
        got = port(megb if dtype else megb.float(), _t(positions), **kw)
    else:
        variables = jax.device_get(jm.init(jax.random.PRNGKey(0), meg_btc))
        jargs = (meg_btc,)
        port = common.Conv1d(16, 24, 3, padding=2, dilation=2, bias=False,
                             compute_dtype=dtype and torch.bfloat16)
        convert.load_by_rules(port, [("weight", ("kernel",), "conv_w",
                                      "params")], variables["params"], {})
        with torch.no_grad():
            got = port(megb if dtype else megb.float())
    return got, _bct(jm.apply(variables, *jargs, **jkw))


@pytest.mark.parametrize("module", ["conv", "merger", "fused_head"])
def test_bf16_casts_where_jax_casts(module):
    """The port's bf16 module within CAST_TOL of the flax module in bf16,
    and the same port module left in fp32 past CAST_MISS of it: the bf16
    agreement comes from casting where JAX casts, not from a tolerance
    wide enough for an fp32 computation."""
    got, want = _cast_case(module, "bfloat16")
    assert _max_err(got, want) <= CAST_TOL
    control, _ = _cast_case(module, None)
    assert _max_err(control, want) > CAST_MISS


def test_fused_head_equals_the_unfused_ops():
    """In fp32 the fused head is the unfused merger mix, initial conv and
    subject layers on the same parameters (associativity; rtol/atol
    1e-5), with each sample's subject from rec_subjects; without the
    per-recording arrays it falls back to the unfused ops, silently."""
    _, port, _, _, (args, kw) = _model_case(fused_head=True)
    unfused = SimpleConv(**TINY).eval()
    unfused.load_state_dict(port.state_dict())
    subjects = kw["rec_subjects"][kw["rec_index"]]
    with torch.no_grad():
        got = port(*args, **kw)
        want = unfused(args[0], subjects, args[2],
                       **{k: v for k, v in kw.items() if k != "rec_subjects"})
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        per_recording = {k: v for k, v in kw.items() if k != "rec_subjects"}
        torch.testing.assert_close(port(*args, **per_recording),
                                   unfused(*args, **per_recording),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_simpleconv_recipe_matches_jax(precision):
    """The whole eval-mode SimpleConv with the recipe's options: fp32
    structural options at rtol/atol 1e-4; bf16 (the estimate in bf16)
    within RECIPE_TOL in norm."""
    options = {**STRUCTURE, **(BF16 if precision == "bf16" else {})}
    jmodel, port, variables, (jargs, jkw), (args, kw) = _model_case(
        **options)
    want = jmodel.apply(variables, *jargs, **jkw)
    with torch.no_grad():
        got = port(*args, **kw)
    assert got.shape == (3, 8, 40)
    if precision == "fp32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    else:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert _norm_err(got, want) <= RECIPE_TOL


@pytest.fixture(scope="module")
def recipe_solvers(tmp_path_factory):
    """Untrained tiny_args JAX solvers with the recipe's options and
    fused_conv_bn (no merger dropout): "fp32" the structural options,
    "bf16" the whole recipe (bf16 compute, estimates, scores and wire);
    seeded running statistics."""
    tmp = tmp_path_factory.mktemp("recipe")
    cache = tmp / "fake_cache"
    cache.mkdir()
    solvers = {}
    with env.temporary(cache=cache):
        for name in ("fp32", "bf16"):
            args = tiny_args(cache, tmp / name)
            args.simpleconv.update(fused_conv_bn=True, merger_dropout=0.,
                                   **STRUCTURE)
            if name == "bf16":
                args.simpleconv.update(BF16)
                args.clip.compute_dtype = "bfloat16"
                args.parallel.transfer_dtype = "bfloat16"
            solver = bm_train.get_solver(args, training=True)
            rng = np.random.RandomState(0)
            stats = jax.tree_util.tree_map_with_path(
                lambda p, v: ((rng.randn(*v.shape) * 0.1)
                              if p[-1].key == "mean"
                              else rng.uniform(0.5, 1.5, v.shape)
                              ).astype(np.float32),
                jax.device_get(solver.state["batch_stats"]))
            solver.state = {**solver.state,
                            "batch_stats": jax.device_put(stats)}
            solvers[name] = solver
        yield solvers


def _port(cls, solver):
    state = jax.device_get(solver.state)
    return cls(solver.args, solver.model.in_channels["meg"],
               solver.model.out_channels, solver.model.n_subjects,
               state["params"], state["batch_stats"],
               {k: np.asarray(v) for k, v in solver.norm_arrays.items()},
               device="cpu")


def _batches(solver):
    """STEPS batches of 6 items, 3 from each training recording."""
    dsets = solver.datasets.train.datasets
    return [SegmentBatch.collate([d[i] for d in dsets
                                  for i in range(3 * s, 3 * s + 3)])
            for s in range(STEPS)]


def _on_the_wire(batch, dtype):
    """The batch with meg and features as they arrive after a cast to
    `dtype` on the host (what the port's Server sends), in fp32."""
    if dtype is None:
        return batch
    return dataclasses.replace(batch, **{
        name: np.asarray(getattr(batch, name)).astype(dtype).astype(
            np.float32) for name in ("meg", "features")})


@pytest.mark.parametrize("override", [False, True],
                         ids=["bound", "override"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_recipe_forward_batch_matches_jax_solver(recipe_solvers, precision,
                                                 override):
    """Server.forward_batch against the JAX solver's forward_batch, on the
    same batch as it crosses the wire: the estimate at rtol/atol 1e-4 in
    fp32 and within RECIPE_TOL in norm in bf16 (in bf16, as
    output_dtype says), the output at 1e-4 / exactly the bf16 wire's,
    mask and keep equal. With `override`, recording 0's rows carry
    another subject than the table's, and both solvers compute with the
    batch's own pair (the estimate then differs from the bound one)."""
    solver = recipe_solvers[precision]
    batch = _batches(solver)[0]
    rec = np.asarray(batch.recording_index)
    table = np.asarray(solver.norm_arrays["rec_subjects"])
    assert (np.asarray(batch.subject_index) == table[rec]).all()
    if override:
        subjects = np.where(rec == 0, table[1 - rec], table[rec])
        batch = dataclasses.replace(batch,
                                    subject_index=subjects.astype(np.int32))
    wire = solver.args.parallel.transfer_dtype
    want = solver.forward_batch(_on_the_wire(batch, wire))
    server = _port(Server, solver)
    est, out, mask, keep = server.forward_batch(batch)
    if precision == "fp32":
        assert est.dtype == torch.float32
        np.testing.assert_allclose(_np(est), _np(want[0]), rtol=1e-4,
                                   atol=1e-4)
    else:
        assert est.dtype == torch.bfloat16
        assert _norm_err(est, want[0]) <= RECIPE_TOL
    np.testing.assert_allclose(_np(out), _np(want[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(mask.numpy(), want[2])
    np.testing.assert_array_equal(keep.numpy(), want[3])
    if override:
        bound = server.forward_batch(_batches(solver)[0])[0]
        assert _norm_err(est, bound) > 4 * (1e-4 if precision == "fp32"
                                            else RECIPE_TOL)


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return np.asarray(tree)


def test_recipe_train_steps_bf16_match_jax_solver(recipe_solvers):
    """Three Trainer.steps of the whole bf16 recipe (conv_stats in bf16 on
    the fused layers, bf16 CLIP scores, Adam and statistics in fp32)
    against the JAX solver's jitted step on the same batches, each as the
    bf16 wire gives it to JAX: every loss within RECIPE_TOL relative, keep
    and count exactly, every parameter's first-step gradient within
    RECIPE_TOL in norm (a bias's within BIAS_GRAD_TOL), and after the
    steps the parameters and running statistics still fp32, every
    parameter within Adam's bound of 2 lr per step of JAX's (bf16 turns
    sub-roundoff gradients into steps of either sign) and every running
    statistic within MODULE_TOL."""
    solver = recipe_solvers["bf16"]
    trainer = _port(Trainer, solver)
    assert trainer.model.encoders["meg"].fused == [True, True]
    step = solver._build_step(True, False, False)
    state = jax.tree_util.tree_map(jnp.array, solver.state)
    rng = jax.random.PRNGKey(0)
    rules = convert.simpleconv_rules(trainer.model)
    wire = solver.args.parallel.transfer_dtype
    for i, batch in enumerate(_batches(solver)):
        arrays = batch.to_device(wire)
        pad = jnp.ones(len(batch), jnp.float32)
        if i == 0:
            grads = jax.device_get(jax.grad(lambda p: solver._loss_and_aux(
                p, state["batch_stats"], arrays, solver.norm_arrays, pad,
                None, None, rng, True, False)[0])(state["params"]))
        state, want = step(state, arrays, solver.norm_arrays, pad, None,
                           None, rng)
        got = trainer.step(batch)
        assert abs(got["loss"].item() - float(want["loss"])) \
            <= RECIPE_TOL * abs(float(want["loss"]))
        assert got["keep"].item() == float(want["keep"])
        assert got["count"].item() == float(want["count"]) == len(batch)
        if i == 0:
            for tkey, fpath, kind, coll in rules:
                if coll == "params":
                    grad = trainer.model.get_parameter(tkey).grad
                    assert grad.dtype == torch.float32
                    tol = (BIAS_GRAD_TOL if tkey.endswith(".bias")
                           else RECIPE_TOL)
                    assert _norm_err(grad, _untransform(
                        kind, _leaf(grads, fpath))) <= tol, tkey
    lr = solver.args.optim.lr
    state = jax.device_get(state)
    for tkey, fpath, kind, coll in rules:
        want = _untransform(kind, _leaf(state[coll], fpath))
        if coll == "params":
            got = trainer.model.get_parameter(tkey)
            assert got.dtype == torch.float32
            assert np.abs(_np(got) - want).max() <= 2 * STEPS * lr, tkey
        else:
            got = trainer.model.get_buffer(tkey)
            assert got.dtype == torch.float32
            assert _max_err(got, want) <= MODULE_TOL, tkey
