"""``models.common.Conv1d``'s SAME convs (stride 1, ungrouped, odd
kernel): their input gradient is a forward conv of the output's gradient
(``_SameConv``), held here to autograd's conv gradients (cuDNN's
backward-data on the card), and every other conv stays autograd's. The
models built on them are held to the JAX package by the model and
train-step tests."""

import pytest
import torch
import torch.nn.functional as F

from brainmagick_tpu_torch.models.common import Conv1d, ConvSequence

#: (C, O, k, dilation, bias, compute dtype)
CASES = [(3, 5, 3, 1, True, None), (4, 6, 3, 2, False, None),
         (2, 3, 5, 4, True, None), (5, 5, 1, 1, True, None),
         (6, 4, 3, 16, False, None), (4, 4, 3, 2, True, torch.float64)]


@pytest.mark.parametrize("case", CASES)
def test_same_conv_gradients_are_autograds(case):
    """Output, dx, dw and db of a SAME Conv1d against ``F.conv1d``'s
    autograd in float64, on a ragged length."""
    cin, cout, k, d, bias, dtype = case
    gen = torch.Generator().manual_seed(sum(case[:4]))
    conv = Conv1d(cin, cout, k, padding=d * (k // 2), dilation=d, bias=bias,
                  compute_dtype=dtype).double()
    assert conv._same
    x = torch.randn(3, cin, 37, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    cot = torch.randn(3, cout, 37, generator=gen, dtype=torch.float64)
    y = conv(x)
    grads = torch.autograd.grad(y, [x, *conv.parameters()], cot)
    x2 = x.detach().clone().requires_grad_(True)
    params = [p.detach().clone().requires_grad_(True)
              for p in conv.parameters()]
    want_y = F.conv1d(x2, params[0], params[1] if bias else None,
                      padding=d * (k // 2), dilation=d)
    want = torch.autograd.grad(want_y, [x2, *params], cot)
    torch.testing.assert_close(y, want_y, rtol=1e-12, atol=1e-12)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_fp32_same_conv_gradients_within_rounding():
    """In fp32 the forward-conv dx sums in another order than autograd's:
    each gradient lies as close to float64's as autograd's fp32 one does
    (within twice its distance, plus 1e-6)."""
    gen = torch.Generator().manual_seed(0)
    conv = Conv1d(16, 24, 3, padding=4, dilation=4)
    x = torch.randn(4, 16, 101, generator=gen, requires_grad=True)
    cot = torch.randn(4, 24, 101, generator=gen)
    got = torch.autograd.grad(conv(x), [x, conv.weight, conv.bias], cot)
    plain = torch.autograd.grad(
        F.conv1d(x, conv.weight, conv.bias, padding=4, dilation=4),
        [x, conv.weight, conv.bias], cot)
    w64, b64 = conv.weight.detach().double(), conv.bias.detach().double()
    x64 = x.detach().double()
    args = [t.requires_grad_(True) for t in (x64, w64, b64)]
    want = torch.autograd.grad(F.conv1d(*args, padding=4, dilation=4), args,
                               cot.double())
    for mine, theirs, ref in zip(got, plain, want):
        err = float((mine.double() - ref).abs().max())
        autograd_err = float((theirs.double() - ref).abs().max())
        assert err <= 2 * autograd_err + 1e-6, (err, autograd_err)


def test_only_same_convs_take_the_forward_dx():
    """Strided, grouped, even-kernel or unpadded convs stay autograd's, and
    so does a conv outside autograd (eval, export)."""
    assert not Conv1d(4, 4, 3, stride=2, padding=1)._same
    assert not Conv1d(4, 4, 3, padding=1, groups=2)._same
    assert not Conv1d(4, 4, 4, padding=2)._same
    assert not Conv1d(4, 4, 3, padding=0)._same
    assert not Conv1d(4, 4, 3, padding=1, padding_mode="reflect")._same
    conv = Conv1d(4, 4, 3, padding=1)
    seen = []
    conv.register_forward_hook(lambda m, i, o: seen.append(o.grad_fn))
    with torch.no_grad():
        conv(torch.randn(1, 4, 9))
    conv(torch.randn(1, 4, 9, requires_grad=True))
    assert seen[0] is None
    assert type(seen[1]).__name__ == "_SameConvBackward"


def test_encoder_convs_take_the_forward_dx():
    """A dilated ConvSequence's convs (the SimpleConv encoder's, unfused)
    and its GLU convs are SAME convs."""
    seq = ConvSequence([8, 12, 12, 12], kernel=3, dilation_growth=2,
                       dilation_period=5, skip=True, glu=2, glu_context=1)
    convs = [m for m in seq.modules() if isinstance(m, Conv1d)]
    assert len(convs) >= 4 and all(c._same for c in convs)
