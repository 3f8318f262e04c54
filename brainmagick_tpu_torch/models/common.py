"""Shared model blocks: subject layers, spatial attention over sensor
positions, dilated conv stacks, in eval and train mode.

Port of ``brainmagick_tpu/models/common.py`` in torch's natural [B, C, T]
Conv1d layout. Submodules carry the reference ``bm`` names
(``sequence.{k}.{i}``, ``glus.{k}.0``, ``heads``, ``weights``), which are
the keys ``brainmagick_tpu.convert`` maps flax leaves onto. Train mode
follows flax: BatchNorm normalizes with the biased batch variance and
keeps it in its running average, and the merger's dropout disk comes from
an explicit ``torch.Generator`` (or a centre the caller passes).
"""

from __future__ import annotations

import functools
import math
import typing as tp

import torch
from torch import nn

from ..ops.conv_bn import batch_mean_var, conv_stats

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


def init_conv_(conv: nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal kernel (fan_in = in_channels/groups x k, as flax's
    default) and a zero bias. ConvTranspose1d stores [in, out, k]."""
    if isinstance(conv, nn.ConvTranspose1d):
        fan_in = conv.weight.shape[0] * conv.weight.shape[2]
    else:
        fan_in = conv.weight.shape[1] * conv.weight.shape[2]
    normal_(conv.weight, fan_in ** -0.5, generator)
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
        # x: [B, C_in, T], subjects: [B] -> [B, C_out, T]
        return torch.einsum("bct,bcd->bdt", x, self.weights[subjects])


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
                  center: tp.Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """Softmax weights [B, chout, C] over the sensors.

        pos_emb is either [B, C, D] per sample, or [R, C, D] per
        recording together with rec_index [B] and rec_positions
        [R, C, 2]: then R softmax rows are computed instead of B. In
        train mode with dropout, the disk centre is `center` ([2]) when
        given, else drawn uniformly in [0, 1)^2 from `generator`."""
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
        scores = torch.einsum("rcd,od->roc", embedding, self.heads)
        weights = torch.softmax(scores + score_offset[:, None, :], dim=2)
        if per_recording:
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
        """meg [B, C, T], positions [B, C, 2] -> [B, chout, T]; the other
        arguments as in `attention`."""
        weights = self.attention(positions, pos_emb, rec_index,
                                 rec_positions, generator, center)
        return torch.einsum("bct,boc->bot", meg, weights)


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
    BatchNorm1d keeps the unbiased one. Eval mode is torch's."""

    #: flax's running-average weight of the old statistics
    FLAX_MOMENTUM = 0.99

    def __init__(self, channels: int) -> None:
        super().__init__(channels, eps=1e-5, momentum=1 - self.FLAX_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x32 = x.float()
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
    """Stack of dilated 1D convs (stride 1, SAME padding) with BatchNorm,
    activation, residual skips and interleaved GLU gates. Layer k is
    ``sequence[k]`` = (conv, BatchNorm, activation) and its gate is
    ``glus[k]`` = (conv, GLU) or None.

    With `fused_conv_bn`, every layer that flax's ConvSequence runs as a
    ``FusedConvBN`` (BatchNorm'd, and ungrouped or the first) has a conv
    without bias, and in train mode runs ``ops.conv_bn.conv_stats``: the
    conv and its batch sums in one pass, normalized from those sums. In
    eval mode such a layer is the plain conv and BatchNorm on the running
    statistics. The key layout is the same for both settings."""

    def __init__(self, channels: tp.Sequence[int], kernel: int = 4,
                 dilation_growth: int = 1,
                 dilation_period: tp.Optional[int] = None,
                 dropout: float = 0.0, groups: int = 1,
                 batch_norm: bool = False, dropout_input: float = 0.0,
                 skip: bool = False, activation_on_last: bool = True,
                 glu: int = 0, glu_context: int = 0, glu_glu: bool = True,
                 activation: tp.Callable[[], nn.Module] = nn.ReLU,
                 fused_conv_bn: bool = False) -> None:
        super().__init__()
        if kernel % 2 != 1:
            raise NotImplementedError("even conv kernels (SAME padding "
                                      "needs an odd kernel)")
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
            fused = fused_conv_bn and has_bn and (groups == 1 or k == 0)
            self.fused.append(fused)
            layers: tp.List[nn.Module] = []
            if k == 0 and dropout_input:
                layers.append(nn.Dropout(dropout_input))
            if dilation_period and k % dilation_period == 0:
                dilation = 1
            # flax's FusedConvBN has no conv bias (BatchNorm cancels it)
            layers.append(nn.Conv1d(
                chin, chout, kernel, padding=kernel // 2 * dilation,
                dilation=dilation, groups=groups if k > 0 else 1,
                bias=not fused))
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
                    nn.Conv1d(chout, 2 * chout if glu_glu else chout, width,
                              padding=glu_context),
                    nn.GLU(dim=1) if glu_glu else activation()))
            else:
                self.glus.append(None)

    @staticmethod
    def _fused_train(layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """(conv, BatchNorm) in train mode through conv_stats, the rest of
        the layer (input dropout before, activation after) as it is."""
        pos = next(i for i, m in enumerate(layer)
                   if isinstance(m, nn.Conv1d))
        conv, bn = layer[pos], layer[pos + 1]
        y, s, ss = conv_stats(layer[:pos](x), conv.weight, conv.dilation[0])
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
