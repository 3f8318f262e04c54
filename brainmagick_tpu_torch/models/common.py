"""Shared model blocks: subject layers, spatial attention over sensor
positions, dilated conv stacks (inference).

Port of ``brainmagick_tpu/models/common.py`` in torch's natural [B, C, T]
Conv1d layout. Submodules carry the reference ``bm`` names
(``sequence.{k}.{i}``, ``glus.{k}.0``, ``heads``, ``weights``), which are
the keys ``brainmagick_tpu.convert`` maps flax leaves onto.
"""

from __future__ import annotations

import functools
import math
import typing as tp

import torch
from torch import nn

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
    """Spatial attention over sensors, eval mode: learned heads attend over
    Fourier embeddings of sensor positions and merge C input channels into
    `chout` virtual channels. Invalid (padded) sensors get -inf before the
    softmax; a row whose every sensor is invalid gets a uniform softmax
    instead of NaN. Training-time dropout and the usage penalty do not
    act at inference; the per-subject heads are not ported."""

    def __init__(self, chout: int, pos_dim: int = 256) -> None:
        super().__init__()
        if pos_dim % 4:
            raise ValueError(f"pos_dim must be a multiple of 4, got {pos_dim}")
        self.pos_dim = pos_dim
        self.heads = nn.Parameter(torch.empty(chout, pos_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.heads, self.pos_dim ** -0.5, generator)

    def forward(self, meg: torch.Tensor, positions: torch.Tensor,
                pos_emb: tp.Optional[torch.Tensor] = None,
                rec_index: tp.Optional[torch.Tensor] = None,
                rec_positions: tp.Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """meg [B, C, T], positions [B, C, 2] -> [B, chout, T].

        pos_emb is either [B, C, D] per sample, or [R, C, D] per
        recording together with rec_index [B] and rec_positions
        [R, C, 2]: then R softmax rows are computed instead of B."""
        per_recording = rec_index is not None and pos_emb is not None
        if per_recording:
            embedding, mask_positions = pos_emb, rec_positions
        else:
            embedding = pos_emb if pos_emb is not None \
                else fourier_emb(positions, self.pos_dim)
            mask_positions = positions
        invalid = is_invalid_position(mask_positions)          # [R or B, C]
        all_invalid = invalid.all(dim=-1, keepdim=True)
        score_offset = torch.zeros(invalid.shape, dtype=torch.float32,
                                   device=invalid.device)
        score_offset = score_offset.masked_fill(invalid & ~all_invalid,
                                                -math.inf)
        scores = torch.einsum("rcd,od->roc", embedding, self.heads)
        weights = torch.softmax(scores + score_offset[:, None, :], dim=2)
        if per_recording:
            weights = weights[rec_index]                       # [B, O, C]
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


class ConvSequence(nn.Module):
    """Stack of dilated 1D convs (stride 1, SAME padding) with BatchNorm on
    running statistics, activation, residual skips and interleaved GLU
    gates, in eval mode. Layer k is ``sequence[k]`` = (conv, BatchNorm,
    activation) and its gate is ``glus[k]`` = (conv, GLU) or None."""

    def __init__(self, channels: tp.Sequence[int], kernel: int = 4,
                 dilation_growth: int = 1,
                 dilation_period: tp.Optional[int] = None,
                 dropout: float = 0.0, groups: int = 1,
                 batch_norm: bool = False, dropout_input: float = 0.0,
                 skip: bool = False, activation_on_last: bool = True,
                 glu: int = 0, glu_context: int = 0, glu_glu: bool = True,
                 activation: tp.Callable[[], nn.Module] = nn.ReLU) -> None:
        super().__init__()
        if kernel % 2 != 1:
            raise NotImplementedError("even conv kernels (SAME padding "
                                      "needs an odd kernel)")
        self.skip = skip
        self.sequence = nn.ModuleList()
        self.glus = nn.ModuleList()
        channels = tuple(channels)
        dilation = 1
        for k, (chin, chout) in enumerate(zip(channels[:-1], channels[1:])):
            is_last = k == len(channels) - 2
            layers: tp.List[nn.Module] = []
            if k == 0 and dropout_input:
                layers.append(nn.Dropout(dropout_input))
            if dilation_period and k % dilation_period == 0:
                dilation = 1
            layers.append(nn.Conv1d(
                chin, chout, kernel, padding=kernel // 2 * dilation,
                dilation=dilation, groups=groups if k > 0 else 1))
            dilation *= dilation_growth
            if activation_on_last or not is_last:
                if batch_norm:
                    # flax BatchNorm: eps 1e-5, running-average weight 0.99
                    layers.append(nn.BatchNorm1d(chout, eps=1e-5,
                                                 momentum=0.01))
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer, glu in zip(self.sequence, self.glus):
            old_x = x
            x = layer(x)
            # residual when shapes match (stride-1 stacks)
            if self.skip and x.shape == old_x.shape:
                x = x + old_x
            if glu is not None:
                x = glu(x)
        return x
