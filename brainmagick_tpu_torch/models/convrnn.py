"""ConvRNN: strided conv encoders, a stacked LSTM, local attention and a
transposed-conv decoder (the encode task's model, and the
``decoder_convrnn`` preset's).

Port of ``brainmagick_tpu/models/convrnn.py`` in torch's [B, C, T]
layout (the LSTM runs on [B, T, C]). Forward: subject layers on the MEG,
a subject embedding at the ``input`` and/or the ``lstm``, optionally one
concatenated branch, each input padded on the right to ``valid_length``
and encoded by its own strided ``ConvSequence``, the LSTM stack
(optionally bidirectional, optionally over reversed time), residual local
attention blocks, the decoder (transposed convs that follow flax's
padding, see ``common.ConvSequence``), the linear or complex 1x1 head,
then the first `length` samples. The activation is ReLU throughout:
``relu_leakiness`` reaches the flax ``ConvSequence`` as ``leakiness``,
which only its ``rewrite`` option reads, so it changes nothing here, and
``lstm_dropout`` is read by nothing in the JAX package either.

Every weight is initialized from an explicit ``torch.Generator``
(``reset_parameters``): LeCun-normal convs and LSTM input kernels,
orthogonal LSTM recurrent kernels, zero biases.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from .common import (BatchNorm, Conv1d, ConvSequence, ScaledEmbedding,
                     StackedLSTM, SubjectLayers, init_conv_)

class LocalAttention(nn.Module):
    """Multi-head attention of each step over the steps within `radius`,
    with a learned relative-position table (``embedding``, [2 radius + 1,
    C / heads], the flax module's ``rel_emb``) that enters the scores and
    the output at weight 0.3, no 1/sqrt(d) scaling; then a 1x1 conv
    (``fc``), BatchNorm, ReLU and a learned per-channel ``scale`` (0.1 at
    initialization). [B, C, T] in and out; the caller adds the
    residual."""

    def __init__(self, channels: int, radius: int = 50,
                 heads: int = 4) -> None:
        super().__init__()
        if channels % heads:
            raise ValueError(f"{channels} channels over {heads} heads")
        self.radius = radius
        self.heads = heads
        self.content = Conv1d(channels, channels, 1)
        self.query = Conv1d(channels, channels, 1)
        self.key = Conv1d(channels, channels, 1)
        self.embedding = nn.Parameter(
            torch.empty(2 * radius + 1, channels // heads))
        self.fc = Conv1d(channels, channels, 1)
        self.bn = BatchNorm(channels)
        self.scale = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The table as flax draws it (cumulative sums of N(0, 1) rows over
        the square root of their count) and `scale` at 0.1; the convs and
        BatchNorm are the caller's."""
        rows = self.embedding.shape[0]
        draw = torch.randn(self.embedding.shape, generator=generator)
        with torch.no_grad():
            self.embedding.copy_(draw.cumsum(0) / torch.arange(
                1, rows + 1, dtype=draw.dtype).sqrt()[:, None])
            self.scale.fill_(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, channels, length = x.shape
        shape = (batch, self.heads, channels // self.heads, length)
        content = self.content(x).view(shape)
        query = self.query(x).view(shape)
        key = self.key(x).view(shape)
        steps = torch.arange(length, device=x.device)
        relative = steps[:, None] - steps[None, :]                  # [T, S]
        embs = self.embedding[self.radius + relative.clamp(
            -self.radius, self.radius)]                             # [T, S, D]
        dots = torch.einsum("bhct,bhcs->bhts", query, key)
        dots = dots + 0.3 * torch.einsum("bhct,tsc->bhts", query, embs)
        dots = dots.masked_fill(relative.abs() > self.radius, -math.inf)
        weights = torch.softmax(dots, dim=-1)
        out = torch.einsum("bhts,bhcs->bhct", weights, content)
        out = out + 0.3 * torch.einsum("bhts,tsc->bhct", weights, embs)
        out = F.relu(self.bn(self.fc(out.reshape(batch, channels, length))))
        return out * self.scale[:, None]


class ConvRNN(nn.Module):
    """The constructor takes the flax module's fields and keeps them as
    attributes of the same names (``convert.convrnn_rules`` reads them);
    ``subject_layers``, ``subject_embedding``, ``encoders``, ``lstm``,
    ``attentions``, ``decoder`` and ``final`` hold the submodules (None
    when off). In train mode ``conv_dropout`` and ``dropout_input`` draw
    their masks from the `generator` ``forward`` takes, or take the
    `masks` it is given (the encoders' in sorted order, then the
    decoder's)."""

    def __init__(self, in_channels: tp.Mapping[str, int], out_channels: int,
                 hidden: tp.Mapping[str, int], depth: int = 2,
                 linear_out: bool = False, complex_out: bool = False,
                 concatenate: bool = False, kernel_size: int = 4,
                 stride: int = 2, growth: float = 1., lstm: int = 2,
                 flip_lstm: bool = False, bidirectional_lstm: bool = False,
                 attention: int = 0, heads: int = 4,
                 conv_dropout: float = 0.0, lstm_dropout: float = 0.0,
                 dropout_input: float = 0.0, batch_norm: bool = False,
                 relu_leakiness: float = 0.0, n_subjects: int = 200,
                 subject_dim: int = 64,
                 embedding_location: tp.Sequence[str] = ("lstm",),
                 embedding_scale: float = 1.0, subject_layers: bool = False,
                 subject_layers_dim: str = "input") -> None:
        super().__init__()
        if set(in_channels) != set(hidden):
            raise ValueError("in_channels and hidden keys must match")
        if linear_out and complex_out:
            raise ValueError("linear_out and complex_out are exclusive")
        use_final = linear_out or complex_out
        if not use_final and depth <= 0:
            raise ValueError("without a linear or complex head, depth must "
                             "be > 0")
        self.in_channels = dict(in_channels)
        self.out_channels = out_channels
        self.hidden = dict(hidden)
        self.depth = depth
        self.linear_out = linear_out
        self.complex_out = complex_out
        self.concatenate = concatenate
        self.stride = stride
        self.growth = growth
        self.flip_lstm = flip_lstm
        self.conv_dropout = conv_dropout
        self.lstm_dropout = lstm_dropout
        self.dropout_input = dropout_input
        self.subject_dim = subject_dim
        self.embedding_location = tuple(embedding_location)

        channels = dict(in_channels)
        hidden = dict(hidden)
        self.subject_layers = None
        if subject_layers:
            dim = {"hidden": hidden["meg"],
                   "input": channels["meg"]}[subject_layers_dim]
            self.subject_layers = SubjectLayers(channels["meg"], dim,
                                                n_subjects)
            channels["meg"] = dim
        self.subject_embedding = None
        if subject_dim:
            self.subject_embedding = ScaledEmbedding(
                n_subjects, subject_dim, embedding_scale)
            if "input" in self.embedding_location:
                channels["meg"] += subject_dim
        if concatenate:
            channels = {"concat": sum(channels.values())}
            hidden = {"concat": sum(hidden.values())}

        sizes = {name: [channels[name]] + [int(round(hidden[name] * growth
                                                     ** k))
                                           for k in range(depth)]
                 for name in sorted(channels)}
        lstm_hidden = sum(s[-1] for s in sizes.values())
        params = dict(kernel=kernel_size, stride=stride, dropout=conv_dropout,
                      dropout_input=dropout_input, batch_norm=batch_norm)
        self.encoders = nn.ModuleDict({
            name: ConvSequence(size, **params)
            for name, size in sizes.items()})
        width = lstm_hidden
        if subject_dim and "lstm" in self.embedding_location:
            width += subject_dim
        self.lstm = None
        if lstm:
            self.lstm = StackedLSTM(width, lstm_hidden, lstm,
                                    bidirectional_lstm)
            width = lstm_hidden
        self.attentions = nn.ModuleList([
            LocalAttention(width, heads=heads) for _ in range(attention)])
        decoder_sizes = [width] + [int(round(lstm_hidden / growth ** k))
                                   for k in range(1, depth + 1)]
        if not use_final:
            decoder_sizes[-1] = out_channels
        self.decoder = ConvSequence(decoder_sizes, decode=True,
                                    activation_on_last=use_final, **params)
        self.final: tp.Optional[nn.Module] = None
        last = decoder_sizes[-1]
        if linear_out:
            self.final = Conv1d(last, out_channels, 1)
        elif complex_out:
            self.final = nn.Sequential(Conv1d(last, 2 * last, 1), nn.ReLU(),
                                       Conv1d(2 * last, out_channels, 1))

    def valid_length(self, length: int) -> int:
        """The nearest length with no leftover conv steps, at least
        `length`: the encoders' input length."""
        for _ in range(self.depth):
            length = max(math.ceil(length / self.stride) + 1, 1)
        for _ in range(self.depth):
            length = (length - 1) * self.stride
        return int(length)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every weight from `generator` (drawn on the CPU)."""
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
                init_conv_(module, generator)
            elif isinstance(module, nn.BatchNorm1d):
                module.reset_parameters()
            elif isinstance(module, (SubjectLayers, ScaledEmbedding,
                                     StackedLSTM, LocalAttention)):
                module.reset_parameters(generator)

    def forward(self, inputs: tp.Mapping[str, torch.Tensor],
                subject_index: torch.Tensor,
                positions: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None,
                masks: tp.Optional[tp.Iterable[torch.Tensor]] = None
                ) -> torch.Tensor:
        """inputs {name: [B, C_name, T]} (the encode task's 'meg' and
        'features', or 'meg'), subject_index [B]; `positions` is not read;
        `generator` and `masks` as ``ConvSequence.forward``'s. Returns
        [B, out_channels, T] fp32."""
        masks = None if masks is None else iter(masks)
        length = next(iter(inputs.values())).shape[-1]
        inputs = dict(inputs)
        emb = None
        if self.subject_layers is not None:
            inputs["meg"] = self.subject_layers(inputs["meg"], subject_index)
        if self.subject_embedding is not None:
            emb = self.subject_embedding(subject_index)[:, :, None]
            if "input" in self.embedding_location:
                meg = inputs["meg"]
                inputs["meg"] = torch.cat(
                    [meg, emb.expand(-1, -1, meg.shape[-1])], dim=1)
        if self.concatenate:
            inputs = {"concat": torch.cat(
                [inputs[name] for name in sorted(inputs)], dim=1)}
        valid = self.valid_length(length)
        parts = [self.encoders[name](F.pad(inputs[name],
                                           (0, valid - length)),
                                     generator, masks)
                 for name in sorted(inputs)]
        if emb is not None and "lstm" in self.embedding_location:
            parts.append(emb.expand(-1, -1, parts[0].shape[-1]))
        x = torch.cat(parts, dim=1)
        if self.lstm is not None:
            x = x.transpose(1, 2)
            if self.flip_lstm:
                x = x.flip(1)
            x = self.lstm(x)
            if self.flip_lstm:
                x = x.flip(1)
            x = x.transpose(1, 2)
        for attention in self.attentions:
            x = x + attention(x)
        x = self.decoder(x, generator, masks)
        if self.final is not None:
            x = self.final(x)
        return x[..., :length]
