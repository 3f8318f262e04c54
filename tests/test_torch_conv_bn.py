"""The port's conv_stats (fused dilated conv + BatchNorm sums) and its
ConvSequence in train mode, against the JAX package on the same numpy
inputs. The port's layout is [B, C, T] with Conv1d weights [O, C, k]; the
JAX function's is [B, T, C] with [k, C, O], so the tests transpose. On
the CPU the port runs conv_stats' plain version; the JAX side runs the
Pallas kernel in interpret mode, as tests/test_pallas.py does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainmagick_tpu.convert import _untransform
from brainmagick_tpu.convert import conv_sequence_rules as jax_seq_rules
from brainmagick_tpu.models import common as jcommon
from brainmagick_tpu.ops import pallas_conv_bn as jconv
from brainmagick_tpu_torch import convert
from brainmagick_tpu_torch.models import common
from brainmagick_tpu_torch.ops import conv_bn


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _btc(x_bct):
    return np.swapaxes(np.asarray(x_bct), 1, 2)


def _operands(B, C, O, T, k, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, T).astype(np.float32)            # port layout
    w = (0.3 * rng.randn(O, C, k)).astype(np.float32)    # Conv1d layout
    return x, w


def _loss(y, s, ss, lib):
    """tests the three cotangents at once (pallas_conv_bn.self_test)"""
    return (lib.sum(y ** 2) + lib.sum(lib.sin(s))
            + lib.sum(lib.sqrt(ss + 1.0)))


#: (B, C, O, T, k, dilation): self_test's shape, ragged shapes, k = 5, and
#: k = 9 and 11 (the fp32 tensor-core route takes any odd k)
SHAPES = [(3, 24, 16, 37, 3, 4), (1, 1, 1, 1, 3, 1), (2, 3, 5, 7, 3, 2),
          (2, 17, 33, 30, 3, 16), (2, 6, 4, 11, 5, 1), (2, 6, 5, 23, 9, 1),
          (2, 7, 4, 41, 11, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_stats_matches_jax(shape):
    """y, s, ss against the Pallas kernel (interpret mode) and the XLA
    reference; dx, dw through autograd against jax.grad of the reference.
    rtol/atol 1e-4 forward and 1e-3 for gradients, as in self_test."""
    B, C, O, T, k, d = shape
    x, w = _operands(B, C, O, T, k, seed=sum(shape))
    xj, wj = jnp.asarray(_btc(x)), jnp.asarray(np.transpose(w, (2, 1, 0)))
    got = conv_bn.conv_stats(_t(x), _t(w), d)
    for impl in ("interpret", "xla"):
        want = jconv.conv_stats(xj, wj, d, impl)
        np.testing.assert_allclose(got[0].detach().numpy(), _btc(want[0]),
                                   rtol=1e-4, atol=1e-4)
        for g, r in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                       rtol=1e-4, atol=1e-4)

    gx_ref, gw_ref = jax.grad(
        lambda a, b: _loss(*jconv._ref_conv_stats(a, b, d), jnp),
        argnums=(0, 1))(xj, wj)
    xt, wt = _t(x, grad=True), _t(w, grad=True)
    _loss(*conv_bn.conv_stats(xt, wt, d), torch).backward()
    np.testing.assert_allclose(xt.grad.numpy(), _btc(gx_ref), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.transpose(np.asarray(gw_ref), (2, 1, 0)),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("used", ["y", "s", "ss", "s_ss"])
def test_conv_stats_unused_outputs(used):
    """Unused outputs' gradients arrive as None; the backward equals
    autograd through the plain version (rtol/atol 1e-5: the same ops in
    another order)."""
    x, w = _operands(2, 5, 6, 13, 3, seed=7)

    def loss(y, s, ss):
        terms = {"y": (y ** 3).sum(), "s": (s * s).sum(),
                 "ss": ss.sqrt().sum(), "s_ss": (s * ss).sum()}
        return terms[used]

    grads = []
    for fn in (conv_bn.conv_stats, conv_bn._reference_impl):
        xt, wt = _t(x, grad=True), _t(w, grad=True)
        loss(*fn(xt, wt, 3)).backward()
        grads.append((xt.grad, wt.grad))
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_conv_stats_bf16_and_errors():
    """bf16 operands: y in bf16, sums from the fp32 accumulator (the
    JAX reference's bf16 y to one bf16 rounding, rtol 2^-7; the sums to
    1e-4). Bad shapes, even widths and types raise."""
    x, w = _operands(2, 8, 4, 21, 3, seed=3)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    y, s, ss = conv_bn.conv_stats(xb, wb, 2)
    assert y.dtype == torch.bfloat16 and s.dtype == ss.dtype == torch.float32
    xj = jnp.asarray(_btc(xb.float().numpy())).astype(jnp.bfloat16)
    wj = jnp.asarray(np.transpose(wb.float().numpy(), (2, 1, 0))
                     ).astype(jnp.bfloat16)
    want = jconv._ref_conv_stats(xj, wj, 2)
    np.testing.assert_allclose(y.float().numpy(),
                               _btc(want[0].astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)
    for g, r in zip((s, ss), want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-3)
    with pytest.raises(ValueError, match="odd"):
        conv_bn.conv_stats(torch.zeros(1, 2, 3), torch.zeros(4, 2, 2))
    with pytest.raises(ValueError, match=r"\[B, C, T\]"):
        conv_bn.conv_stats(torch.zeros(1, 2, 3), torch.zeros(4, 3, 3))
    # the kernel's launcher checks what it takes before touching the card:
    # bf16 takes any odd k on the tensor cores, and refuses an even one
    with pytest.raises(ValueError, match="bf16 route.*odd k"):
        conv_bn._launch(torch.zeros(1, 2, 3).bfloat16(),
                        torch.zeros(4, 2, 8).bfloat16(), 1)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        conv_bn._launch(torch.zeros(1, 2, 3).half(), torch.zeros(4, 2, 3), 1)


@pytest.mark.parametrize("k, dilation", [(3, 2), (9, 1), (11, 4)])
def test_conv_stats_bf16_matches_jax_interpret(k, dilation):
    """bf16 operands at k = 9 and 11 (and 3), which the bf16 route takes
    like any odd k: the port (its plain version on the CPU) against the
    Pallas kernel in interpret mode on the same bf16 values. y within one
    bf16 rounding of the JAX y (the fp32 sums before the rounding differ
    in order only: 2^-8 of |y| + 1e-5), s and ss rtol/atol 1e-4 (fp32
    sums of 30-odd hundred terms); dx and dw against jax.grad through the
    custom VJP within 2^-7 of each gradient's largest entry (both round
    dY and the result to bf16)."""
    B, C, O, T = 2, 40, 24, 37
    x, w = _operands(B, C, O, T, k, seed=k + dilation)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    xj = jnp.asarray(_btc(xb.float().numpy())).astype(jnp.bfloat16)
    wj = jnp.asarray(np.transpose(wb.float().numpy(), (2, 1, 0))
                     ).astype(jnp.bfloat16)
    want = jconv.conv_stats(xj, wj, dilation, "interpret")
    got = conv_bn.conv_stats(xb, wb, dilation)
    assert got[0].dtype == torch.bfloat16
    want_y = _btc(want[0].astype(jnp.float32))
    np.testing.assert_allclose(got[0].float().numpy(), want_y,
                               rtol=2 ** -8, atol=1e-5)
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)

    def jloss(a, b):
        return _loss(*jconv.conv_stats(a, b, dilation, "interpret"), jnp)
    gx_ref, gw_ref = jax.grad(jloss, argnums=(0, 1))(xj, wj)
    xt, wt = xb.clone().requires_grad_(), wb.clone().requires_grad_()
    _loss(*[t.float() for t in conv_bn.conv_stats(xt, wt, dilation)],
          torch).backward()
    for got_grad, ref in ((xt.grad, _btc(gx_ref.astype(jnp.float32))),
                          (wt.grad, np.transpose(np.asarray(
                              gw_ref.astype(jnp.float32)), (2, 1, 0)))):
        assert got_grad.dtype == torch.bfloat16
        err = np.abs(got_grad.float().numpy() - ref).max()
        assert err <= 2 ** -7 * np.abs(ref).max(), err


def test_batch_mean_var_matches_jax():
    rng = np.random.RandomState(4)
    s = rng.randn(9).astype(np.float32) * 50
    ss = (s ** 2 / 100 + rng.rand(9) * 10).astype(np.float32)
    ss[0] = s[0] ** 2 / 100 * 0.999                     # var clamps to 0
    got = conv_bn.batch_mean_var(_t(s), _t(ss), 100)
    want = jconv.batch_mean_var(jnp.asarray(s), jnp.asarray(ss), 100)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    assert got[1][0] == 0


#: ConvSequence of tests/test_pallas.py::test_fused_conv_bn_matches_
#: standard_path, plus GLU gates (so flax renumbers the gate convs)
SEQ = dict(channels=(16, 16, 16, 16), kernel=3, dilation_growth=2,
           dilation_period=2, skip=True, batch_norm=True, glu=2,
           glu_context=1)


def _seq_pair(fused):
    jseq = jcommon.ConvSequence(stride=1,
                                activation=jcommon.get_activation(True),
                                fused_conv_bn=fused, **SEQ)
    port = common.ConvSequence(activation=common.get_activation(True),
                               fused_conv_bn=fused, **SEQ)
    return jseq, port


def _seq_input():
    return np.random.RandomState(0).randn(3, 16, 40).astype(np.float32)


def _bridged(fused):
    """The JAX ConvSequence's initial variables with seeded running stats,
    loaded into the port's by convert.conv_sequence_rules."""
    jseq, port = _seq_pair(fused)
    x = _seq_input()
    variables = jax.device_get(jseq.init(jax.random.PRNGKey(0),
                                         jnp.asarray(_btc(x))))
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: ((rng.randn(*v.shape) * 0.1) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    rules = convert.conv_sequence_rules(port, "", ())
    convert.load_by_rules(port, rules, variables["params"], stats)
    return jseq, port, variables["params"], stats, rules


def test_conv_sequence_rules_match_the_jax_walk():
    """Unfused, the port's own encoder walk gives the JAX package's rules;
    fused, the FusedConvBN layers take their conv and BatchNorm leaves
    and the gate convs are renumbered."""
    _, port = _seq_pair(False)
    want = jax_seq_rules(
        "", (), channels=SEQ["channels"], batch_norm=True, skip=True,
        scale=None, rewrite=False, post_skip=False, glu=2, dropout=0.,
        dropout_input=0., activation_on_last=True, decode=False)
    assert sorted(convert.conv_sequence_rules(port, "", ())) == sorted(want)
    _, _, params, stats, rules = _bridged(True)
    assert set(params) == {"FusedConvBN_0", "FusedConvBN_1", "FusedConvBN_2",
                           "Conv_0"}
    assert ("glus.1.0.weight", ("Conv_0", "kernel"), "conv_w",
            "params") in rules


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_conv_sequence_train_matches_jax(fused):
    """Train mode against the JAX ConvSequence with the same flag:
    outputs (rtol/atol 1e-4), gradients of every parameter through
    sum(out^2) (1e-3, as test_pallas.py) and the updated running
    statistics (flax's momentum 0.99 and biased variance; 1e-5)."""
    jseq, port, params, stats, rules = _bridged(fused)
    x = _seq_input()
    xj = jnp.asarray(_btc(x))

    def jloss(p):
        out, mut = jseq.apply({"params": p, "batch_stats": stats}, xj,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, mut["batch_stats"])

    (_, (want, new_stats)), grads = jax.value_and_grad(
        jloss, has_aux=True)(params)
    port.train()
    out = port(_t(x))
    np.testing.assert_allclose(out.detach().numpy(), _btc(want), rtol=1e-4,
                               atol=1e-4)
    (out ** 2).sum().backward()
    tensors = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    for tkey, fpath, kind, coll in rules:
        node = grads if coll == "params" else new_stats
        for part in fpath:
            node = node[part]
        want_leaf = _untransform(kind, np.asarray(node))
        got = tensors[tkey].grad if coll == "params" else tensors[tkey]
        tol = 1e-3 if coll == "params" else 1e-5
        np.testing.assert_allclose(got.detach().numpy(), want_leaf,
                                   rtol=tol, atol=tol, err_msg=tkey)


def test_fused_matches_unfused_in_the_port():
    """The fused layers are the same function as conv + BatchNorm with a
    zero conv bias: outputs, gradients and running statistics (1e-5;
    conv_stats' E[y^2] - E[y]^2 against the BatchNorm's own sums)."""
    _, fused = _seq_pair(True)
    _, plain = _seq_pair(False)
    gen = torch.Generator().manual_seed(0)
    for module in plain.modules():
        if isinstance(module, torch.nn.Conv1d):
            common.init_conv_(module, gen)
    fused.load_state_dict(plain.state_dict(), strict=False)
    for layer, is_fused in zip(plain.sequence, fused.fused):
        assert is_fused
        torch.nn.init.zeros_(layer[0].bias)
    outs = []
    for seq in (fused, plain):
        seq.train()
        out = seq(_t(_seq_input()))
        (out ** 2).sum().backward()
        outs.append(out)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    plain_params = dict(plain.named_parameters())
    for name, param in fused.named_parameters():
        torch.testing.assert_close(param.grad, plain_params[name].grad,
                                   rtol=1e-4, atol=1e-5, msg=name)
    plain_buffers = dict(plain.named_buffers())
    for name, buf in fused.named_buffers():
        torch.testing.assert_close(buf, plain_buffers[name], rtol=1e-5,
                                   atol=1e-6, msg=name)
