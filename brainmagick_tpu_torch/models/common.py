"""Shared model blocks: subject layers and embeddings, spatial attention
over sensor positions, dilated conv stacks (strided, and transposed for a
decoder), in eval and train mode.

Port of ``brainmagick_tpu/models/common.py`` in torch's natural [B, C, T]
Conv1d layout. Submodules carry the reference ``bm`` names
(``sequence.{k}.{i}``, ``glus.{k}.0``, ``heads``, ``weights``), which are
the keys ``brainmagick_tpu.convert`` maps flax leaves onto. Train mode
follows flax: BatchNorm normalizes with the biased batch variance and
keeps it in its running average, and the merger's dropout disk comes from
an explicit ``torch.Generator`` (or a centre the caller passes).

A compute dtype (bf16) follows flax's ``dtype=`` rule: parameters,
BatchNorm statistics and softmaxes stay fp32, and each op casts its
operands where the flax module does. The convs (``Conv1d``,
``ConvTranspose1d``) cast input and weights at use and return the compute
dtype; BatchNorm runs in fp32 and casts back; the merger and the subject
layers contract with an fp32 accumulator and return fp32
(``precision.einsum_fp32``).
"""

from __future__ import annotations

import functools
import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_bn import batch_mean_var, conv_stats
from ..precision import einsum_fp32

#: marker for channels with unknown position; a copy of
#: brainmagick_tpu.studies.api.INVALID_POSITION (that module imports pandas)
INVALID_POSITION = -0.1


def is_invalid_position(positions: torch.Tensor) -> torch.Tensor:
    """[..., 2] -> bool mask of padded/unknown sensors."""
    return (positions == INVALID_POSITION).all(dim=-1)


def normal_(tensor: torch.Tensor, std: float,
            generator: torch.Generator) -> None:
    """Fill `tensor` with N(0, std^2) drawn on the CPU from `generator`,
    so the same seed gives the same weights on any device."""
    with torch.no_grad():
        tensor.copy_(torch.randn(tensor.shape, generator=generator) * std)


#: the standard deviation of a unit normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to the variance 1/fan_in, drawn on the CPU from
    `generator` as flax draws it, by the inverse CDF of one fp32 uniform
    a weight (the inverse in float64). Not ``nn.init.trunc_normal_``,
    whose algorithm, and so its draws at a seed, changed between torch
    2.11 and 2.13."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    with torch.no_grad():
        u = torch.rand(tensor.shape, generator=generator).double()
        draw = (torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2)).clamp(-2, 2)
        tensor.copy_(draw * (fan_in ** -0.5 / TRUNCATED_STD))


def init_conv_(conv: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal kernel (fan_in = in_channels/groups x k, as flax's
    default) and a zero bias. ConvTranspose1d stores [in, out, k]."""
    if isinstance(conv, nn.ConvTranspose1d):
        fan_in = conv.weight.shape[0] * conv.weight.shape[2]
    else:
        fan_in = conv.weight.shape[1] * conv.weight.shape[2]
    lecun_normal_(conv.weight, fan_in, generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


def fourier_emb(positions: torch.Tensor, dimension: int = 256,
                margin: float = 0.2) -> torch.Tensor:
    """2D Fourier positional embedding over [-margin, 1+margin]^2 on the
    full `2 pi (k_x x + k_y y)` frequency grid.
    positions: [..., 2] -> [..., dimension]."""
    n_freqs = int((dimension // 2) ** 0.5)
    if n_freqs ** 2 * 2 != dimension:
        raise ValueError(f"dimension must be 2*k^2, got {dimension}")
    freqs = torch.arange(n_freqs, dtype=positions.dtype,
                         device=positions.device)
    width = 1 + 2 * margin
    pos = positions + margin
    # loc[k_x, k_y] = 2 pi (k_x x + k_y y) / width
    loc = 2 * math.pi / width * (
        pos[..., 0:1, None] * freqs[:, None] + pos[..., 1:2, None] * freqs)
    loc = loc.reshape(*positions.shape[:-1], n_freqs * n_freqs)
    return torch.cat([torch.cos(loc), torch.sin(loc)], dim=-1)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with flax ``nn.Conv``'s `compute_dtype` (``dtype=``):
    input, weight and bias cast to it at use, the result in it; with None,
    ``nn.Conv1d`` itself. The parameters stay fp32."""

    def __init__(self, *args, compute_dtype: tp.Optional[torch.dtype] = None,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` with a `compute_dtype`, as ``Conv1d``."""

    def __init__(self, *args, compute_dtype: tp.Optional[torch.dtype] = None,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose1d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class SubjectLayers(nn.Module):
    """Per-subject linear sensor remix: one [C_in, C_out] matrix per
    subject, gathered by subject index."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_subjects: int, init_id: bool = False) -> None:
        super().__init__()
        if init_id and in_channels != out_channels:
            raise ValueError("init_id needs in_channels == out_channels")
        self.init_id = init_id
        self.weights = nn.Parameter(
            torch.empty(n_subjects, in_channels, out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        n_subjects, chin, _ = self.weights.shape
        if self.init_id:
            with torch.no_grad():
                self.weights.copy_(torch.eye(chin).expand(n_subjects, -1, -1)
                                   / chin ** 0.5)
        else:
            normal_(self.weights, chin ** -0.5, generator)

    def forward(self, x: torch.Tensor, subjects: torch.Tensor
                ) -> torch.Tensor:
        # x: [B, C_in, T], subjects: [B] -> [B, C_out, T] fp32 (a bf16 x
        # meets the fp32 weights in fp32, as in the flax module)
        return torch.einsum("bct,bcd->bdt", x.float(), self.weights[subjects])


class ScaledEmbedding(nn.Module):
    """Per-subject embedding whose effective learning rate is boosted by
    `scale`: the table is stored divided by `scale` (N(0, 1/scale^2) at
    initialization) and each lookup is multiplied back."""

    def __init__(self, num_embeddings: int, features: int,
                 scale: float = 10.) -> None:
        super().__init__()
        self.scale = scale
        self.embedding = nn.Embedding(num_embeddings, features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.embedding.weight, 1.0 / self.scale, generator)

    def forward(self, subjects: torch.Tensor) -> torch.Tensor:
        """subjects [B] -> [B, features]."""
        return self.embedding(subjects) * self.scale


class ChannelMerger(nn.Module):
    """Spatial attention over sensors: learned heads attend over Fourier
    embeddings of sensor positions and merge C input channels into
    `chout` virtual channels. Invalid (padded) sensors, and in train mode
    every sensor within `dropout` of a random disk centre, get -inf
    before the softmax; a row whose every sensor is masked gets the finite
    softmax of its raw scores instead of NaN. The per-subject heads are
    not ported."""

    def __init__(self, chout: int, pos_dim: int = 256, dropout: float = 0.,
                 usage_penalty: float = 0.) -> None:
        super().__init__()
        if pos_dim % 4:
            raise ValueError(f"pos_dim must be a multiple of 4, got {pos_dim}")
        self.pos_dim = pos_dim
        self.dropout = dropout
        self.usage_penalty = usage_penalty
        self.heads = nn.Parameter(torch.empty(chout, pos_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.heads, self.pos_dim ** -0.5, generator)

    def attention(self, positions: torch.Tensor,
                  pos_emb: tp.Optional[torch.Tensor] = None,
                  rec_index: tp.Optional[torch.Tensor] = None,
                  rec_positions: tp.Optional[torch.Tensor] = None,
                  generator: tp.Optional[torch.Generator] = None,
                  center: tp.Optional[torch.Tensor] = None,
                  dtype: tp.Optional[torch.dtype] = None,
                  gather: bool = True) -> torch.Tensor:
        """Softmax weights [B, chout, C] over the sensors, fp32.

        pos_emb is either [B, C, D] per sample, or [R, C, D] per
        recording together with rec_index [B] and rec_positions
        [R, C, 2]: then R softmax rows are computed instead of B, and
        returned as they are, [R, chout, C], when not `gather`. The scores
        contract in `dtype` (the meg's) with an fp32 accumulator. In train
        mode with dropout, the disk centre is `center` ([2]) when given,
        else drawn uniformly in [0, 1)^2 from `generator`."""
        per_recording = rec_index is not None and pos_emb is not None
        if per_recording:
            embedding, mask_positions = pos_emb, rec_positions
        else:
            embedding = pos_emb if pos_emb is not None \
                else fourier_emb(positions, self.pos_dim)
            mask_positions = positions
        masked = is_invalid_position(mask_positions)           # [R or B, C]
        if self.training and self.dropout:
            if center is None:
                if generator is None:
                    raise ValueError("merger dropout in train mode needs a "
                                     "generator or a disk centre")
                center = torch.rand(2, generator=generator,
                                    device=generator.device)
            dist = torch.linalg.vector_norm(
                mask_positions - center.to(mask_positions), dim=-1)
            masked = masked | (dist <= self.dropout)
        # the all-masked guard comes after the disk, as in flax
        all_masked = masked.all(dim=-1, keepdim=True)
        score_offset = torch.zeros(masked.shape, dtype=torch.float32,
                                   device=masked.device)
        score_offset = score_offset.masked_fill(masked & ~all_masked,
                                                -math.inf)
        scores = einsum_fp32("rcd,od->roc", embedding, self.heads,
                             dtype=dtype)
        weights = torch.softmax(scores + score_offset[:, None, :], dim=2)
        if per_recording and gather:
            weights = weights[rec_index]                       # [B, O, C]
        return weights

    def penalty(self, weights: torch.Tensor) -> torch.Tensor:
        """The usage penalty of train mode (flax ``sow('losses')``)."""
        return self.usage_penalty * weights.mean(dim=(0, 1)).sum()

    def forward(self, meg: torch.Tensor, positions: torch.Tensor,
                pos_emb: tp.Optional[torch.Tensor] = None,
                rec_index: tp.Optional[torch.Tensor] = None,
                rec_positions: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None,
                center: tp.Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """meg [B, C, T], positions [B, C, 2] -> [B, chout, T] fp32,
        contracted in meg's dtype with an fp32 accumulator; the other
        arguments as in `attention`."""
        weights = self.attention(positions, pos_emb, rec_index,
                                 rec_positions, generator, center,
                                 dtype=meg.dtype)
        return einsum_fp32("bct,boc->bot", meg, weights, dtype=meg.dtype)


def get_activation(gelu: bool = False, relu_leakiness: float = 0.0,
                   gelu_exact: bool = True) -> tp.Callable[[], nn.Module]:
    """Activation module factory: erf GELU (torch's default) or its tanh
    approximation, leaky ReLU, or ReLU."""
    if gelu:
        return functools.partial(
            nn.GELU, approximate="none" if gelu_exact else "tanh")
    if relu_leakiness:
        return functools.partial(nn.LeakyReLU, relu_leakiness)
    return nn.ReLU


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over [B, C, T] with flax's ``nn.BatchNorm`` semantics
    (eps 1e-5, running-average weight 0.99). Train mode normalizes with
    the biased batch variance E[y^2] - E[y]^2 (fp32, clamped at 0) and
    keeps that biased variance in the running average, where torch's
    BatchNorm1d keeps the unbiased one. Eval mode is torch's. Both run in
    fp32 (float64 on a float64 input) and cast back to the input's dtype
    (flax's BatchNorm with ``dtype=float32``, then the cast to the compute
    dtype)."""

    #: flax's running-average weight of the old statistics
    FLAX_MOMENTUM = 0.99

    def __init__(self, channels: int) -> None:
        super().__init__(channels, eps=1e-5, momentum=1 - self.FLAX_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """At least fp32 on any input, the result in the input's dtype."""
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return super().forward(x32).to(x.dtype)
        mean = x32.mean(dim=(0, 2))
        var = ((x32 * x32).mean(dim=(0, 2)) - mean * mean).clamp(min=0.0)
        return self.normalize_train(x32, mean, var).to(x.dtype)

    def normalize_train(self, y: torch.Tensor, mean: torch.Tensor,
                        var: torch.Tensor) -> torch.Tensor:
        """Fold the batch statistics into the running ones, and normalize
        fp32 `y` [B, C, T] with them."""
        m = self.FLAX_MOMENTUM
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return ((y - mean[:, None]) * torch.rsqrt(var + self.eps)[:, None]
                * self.weight[:, None] + self.bias[:, None])


class ConvSequence(nn.Module):
    """Stack of dilated 1D convs with BatchNorm, activation, residual
    skips and interleaved GLU gates. Layer k is ``sequence[k]`` = (conv,
    BatchNorm, activation) and its gate is ``glus[k]`` = (conv, GLU) or
    None.

    Each conv pads ``kernel // 2 * dilation`` on both sides, as flax's
    ``ConvSequence`` does, and steps by `stride` (1 here by default; the
    flax module's default is 2). With `decode`, each is a transposed conv
    that follows flax's ``nn.ConvTranspose``: that pads the stride-dilated
    input by ``kernel // 2`` a side, which is torch's
    ``conv_transpose1d`` with padding ``kernel - 1 - kernel // 2`` on the
    flipped kernel (2T outputs at kernel 4 and stride 2, where
    ``bm``'s ``ConvTranspose1d(padding=2)`` gives the same samples
    shifted by one, 2T - 2 of them).

    With `fused_conv_bn`, every layer that flax's ConvSequence runs as a
    ``FusedConvBN`` (BatchNorm'd, and ungrouped or the first) has a conv
    without bias, and in train mode runs ``ops.conv_bn.conv_stats``: the
    conv and its batch sums in one pass, normalized from those sums. In
    eval mode such a layer is the plain conv and BatchNorm on the running
    statistics. The key layout is the same for both settings. As in flax,
    only a stride-1 conv with an odd kernel, not transposed, fuses.
    Without `bn_conv_bias`, no BatchNorm'd conv has a bias (BatchNorm
    cancels it). The convs run in `compute_dtype` (bf16 or None for the
    input's)."""

    def __init__(self, channels: tp.Sequence[int], kernel: int = 4,
                 dilation_growth: int = 1,
                 dilation_period: tp.Optional[int] = None,
                 stride: int = 1, decode: bool = False,
                 dropout: float = 0.0, groups: int = 1,
                 batch_norm: bool = False, dropout_input: float = 0.0,
                 skip: bool = False, activation_on_last: bool = True,
                 glu: int = 0, glu_context: int = 0, glu_glu: bool = True,
                 activation: tp.Callable[[], nn.Module] = nn.ReLU,
                 fused_conv_bn: bool = False, bn_conv_bias: bool = True,
                 compute_dtype: tp.Optional[torch.dtype] = None) -> None:
        super().__init__()
        if dilation_growth > 1 and kernel % 2 != 1:
            raise ValueError("only odd kernels are supported with dilation")
        self.skip = skip
        self.sequence = nn.ModuleList()
        self.glus = nn.ModuleList()
        #: per layer: whether it is a fused conv + BatchNorm layer
        self.fused: tp.List[bool] = []
        channels = tuple(channels)
        dilation = 1
        for k, (chin, chout) in enumerate(zip(channels[:-1], channels[1:])):
            is_last = k == len(channels) - 2
            has_bn = batch_norm and (activation_on_last or not is_last)
            fused = (fused_conv_bn and has_bn and (groups == 1 or k == 0)
                     and not decode and stride == 1 and kernel % 2 == 1)
            self.fused.append(fused)
            layers: tp.List[nn.Module] = []
            if k == 0 and dropout_input:
                layers.append(nn.Dropout(dropout_input))
            if dilation_period and k % dilation_period == 0:
                dilation = 1
            pad = kernel // 2 * dilation
            # flax's FusedConvBN has no conv bias (BatchNorm cancels it)
            bias = (bn_conv_bias or not has_bn) and not fused
            if decode:
                # flax's nn.ConvTranspose takes neither dilation nor groups
                if pad > kernel - 1:
                    raise NotImplementedError(
                        f"a transposed conv padding {pad} past its kernel "
                        f"{kernel}")
                layers.append(ConvTranspose1d(
                    chin, chout, kernel, stride=stride,
                    padding=kernel - 1 - pad, bias=bias,
                    compute_dtype=compute_dtype))
            else:
                layers.append(Conv1d(
                    chin, chout, kernel, stride=stride, padding=pad,
                    dilation=dilation, groups=groups if k > 0 else 1,
                    bias=bias, compute_dtype=compute_dtype))
            dilation *= dilation_growth
            if activation_on_last or not is_last:
                if batch_norm:
                    layers.append(BatchNorm(chout))
                layers.append(activation())
                if dropout:
                    layers.append(nn.Dropout(dropout))
            self.sequence.append(nn.Sequential(*layers))
            if glu and (k + 1) % glu == 0:
                width = 1 + 2 * glu_context
                self.glus.append(nn.Sequential(
                    Conv1d(chout, 2 * chout if glu_glu else chout, width,
                           padding=glu_context, compute_dtype=compute_dtype),
                    nn.GLU(dim=1) if glu_glu else activation()))
            else:
                self.glus.append(None)

    @staticmethod
    def _fused_train(layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """(conv, BatchNorm) in train mode through conv_stats on operands
        in the conv's compute dtype (x's when None), the rest of the layer
        (input dropout before, activation after) as it is."""
        pos = next(i for i, m in enumerate(layer)
                   if isinstance(m, nn.Conv1d))
        conv, bn = layer[pos], layer[pos + 1]
        x = layer[:pos](x)
        dt = x.dtype if conv.compute_dtype is None else conv.compute_dtype
        y, s, ss = conv_stats(x.to(dt), conv.weight.to(dt), conv.dilation[0])
        mean, var = batch_mean_var(s, ss, y.shape[0] * y.shape[2])
        x = bn.normalize_train(y.float(), mean, var).to(y.dtype)
        return layer[pos + 2:](x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer, glu, fused in zip(self.sequence, self.glus, self.fused):
            old_x = x
            if fused and self.training:
                x = self._fused_train(layer, x)
            else:
                x = layer(x)
            # residual when shapes match (stride-1 stacks)
            if self.skip and x.shape == old_x.shape:
                x = x + old_x
            if glu is not None:
                x = glu(x)
        return x
