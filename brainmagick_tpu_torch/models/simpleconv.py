"""SimpleConv, the paper's brain decoder (unfused head).

Port of ``brainmagick_tpu/models/simpleconv.py``. Forward pipeline:
ChannelMerger spatial attention -> initial 1x1 conv stack -> per-subject
SubjectLayers -> dilated ConvSequence encoder -> final (linear / complex)
1x1 head -> crop to the input length. Layout [B, C, T] in and
[B, F, T] out, as the flax module's public call.

The constructor takes the flax module's keyword arguments and keeps them
as attributes of the same names, so ``brainmagick_tpu.convert
.simpleconv_rules`` reads this module as it reads the flax one. Three of
those names are submodules here, because the reference key layout puts
weights under them: ``merger``, ``initial_linear`` and ``subject_layers``
hold the module when the option is on and None when it is off (the rules
only test them for truth). Options outside the ported slices raise
NotImplementedError naming the option. In train mode the merger's dropout
disk is drawn from the `generator` passed to ``forward``, and
``fused_conv_bn`` runs the encoder's conv + BatchNorm layers through
``ops.conv_bn.conv_stats``.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .common import (ChannelMerger, ConvSequence, SubjectLayers,
                     get_activation, init_conv_)

#: option -> value the slice supports; any other value raises
_SUPPORTED = dict(concatenate=False, post_skip=False, scale=None,
                  rewrite=False, dual_path=0, subject_dim=0, n_fft=None,
                  merger_per_subject=False, dropout=0.,
                  subsample_meg_channels=0, dtype=None, output_dtype=None,
                  output_layout="bct", bn_conv_bias=True, conv_impl="conv",
                  fused_head=False)


class SimpleConv(nn.Module):

    def __init__(self, in_channels: tp.Mapping[str, int], out_channels: int,
                 hidden: tp.Mapping[str, int], depth: int = 4,
                 concatenate: bool = False, linear_out: bool = False,
                 complex_out: bool = False, kernel_size: int = 5,
                 growth: float = 1., dilation_growth: int = 2,
                 dilation_period: tp.Optional[int] = None,
                 skip: bool = False, post_skip: bool = False,
                 scale: tp.Optional[float] = None, rewrite: bool = False,
                 groups: int = 1, glu: int = 0, glu_context: int = 0,
                 glu_glu: bool = True, gelu: bool = False,
                 gelu_exact: bool = True, dual_path: int = 0,
                 conv_dropout: float = 0.0, dropout_input: float = 0.0,
                 batch_norm: bool = False, relu_leakiness: float = 0.0,
                 n_subjects: int = 200, subject_dim: int = 64,
                 subject_layers: bool = False,
                 subject_layers_dim: str = "input",
                 subject_layers_id: bool = False,
                 embedding_scale: float = 1.0,
                 n_fft: tp.Optional[int] = None, fft_complex: bool = True,
                 merger: bool = False, merger_pos_dim: int = 256,
                 merger_channels: int = 270, merger_dropout: float = 0.2,
                 merger_penalty: float = 0.,
                 merger_per_subject: bool = False, dropout: float = 0.,
                 dropout_rescale: bool = True, initial_linear: int = 0,
                 initial_depth: int = 1, initial_nonlin: bool = False,
                 subsample_meg_channels: int = 0, dtype: tp.Any = None,
                 output_dtype: tp.Any = None, output_layout: str = "bct",
                 bn_conv_bias: bool = True, conv_impl: str = "conv",
                 fused_conv_bn: bool = False,
                 fused_head: bool = False) -> None:
        super().__init__()
        given = dict(concatenate=concatenate, post_skip=post_skip,
                     scale=scale, rewrite=rewrite, dual_path=dual_path,
                     subject_dim=subject_dim, n_fft=n_fft,
                     merger_per_subject=merger_per_subject, dropout=dropout,
                     subsample_meg_channels=subsample_meg_channels,
                     dtype=dtype, output_dtype=output_dtype,
                     output_layout=output_layout, bn_conv_bias=bn_conv_bias,
                     conv_impl=conv_impl, fused_head=fused_head)
        for name, value in given.items():
            if value != _SUPPORTED[name]:
                raise NotImplementedError(f"simpleconv.{name}={value!r}")
        if set(in_channels) != {"meg"} or set(hidden) != {"meg"}:
            raise NotImplementedError(
                f"inputs other than 'meg' (the encode task): in_channels "
                f"{dict(in_channels)}, hidden {dict(hidden)}")
        if linear_out and complex_out:
            raise ValueError("linear_out and complex_out are exclusive")
        # the flax module's attributes, read by convert.simpleconv_rules
        self.in_channels = dict(in_channels)
        self.out_channels = out_channels
        self.hidden = dict(hidden)
        self.depth = depth
        self.growth = growth
        self.linear_out = linear_out
        self.complex_out = complex_out
        self.batch_norm = batch_norm
        self.skip = skip
        self.glu = glu
        self.conv_dropout = conv_dropout
        self.dropout_input = dropout_input
        self.merger_channels = merger_channels
        self.merger_pos_dim = merger_pos_dim
        self.initial_depth = initial_depth
        self.subject_layers_dim = subject_layers_dim
        self.merger_dropout = merger_dropout
        self.merger_penalty = merger_penalty
        self.fused_conv_bn = fused_conv_bn
        for name, value in given.items():
            setattr(self, name, value)

        act = get_activation(gelu, relu_leakiness, gelu_exact)
        chin = in_channels["meg"]
        self.merger = None
        if merger:
            # merger_dropout and merger_penalty act only in training
            self.merger = ChannelMerger(
                merger_channels, pos_dim=merger_pos_dim,
                dropout=merger_dropout, usage_penalty=merger_penalty)
            chin = merger_channels
        self.initial_linear = None
        if initial_linear:
            # reference layout: conv at 2 d, activation between convs
            layers: tp.List[nn.Module] = [nn.Conv1d(chin, initial_linear, 1)]
            for _ in range(initial_depth - 1):
                layers += [act(), nn.Conv1d(initial_linear, initial_linear, 1)]
            if initial_nonlin:
                layers.append(act())
            self.initial_linear = nn.Sequential(*layers)
            chin = initial_linear
        self.subject_layers = None
        if subject_layers:
            dim = {"hidden": hidden["meg"], "input": chin}[subject_layers_dim]
            self.subject_layers = SubjectLayers(chin, dim, n_subjects,
                                                subject_layers_id)
            chin = dim

        sizes = [chin] + [int(round(hidden["meg"] * growth ** k))
                          for k in range(depth)]
        use_final = linear_out or complex_out
        if not use_final:
            sizes[-1] = out_channels
        self.encoders = nn.ModuleDict({"meg": ConvSequence(
            sizes, kernel=kernel_size, dilation_growth=dilation_growth,
            dilation_period=dilation_period, dropout=conv_dropout,
            groups=groups, batch_norm=batch_norm,
            dropout_input=dropout_input, skip=skip,
            activation_on_last=use_final, glu=glu, glu_context=glu_context,
            glu_glu=glu_glu, activation=act, fused_conv_bn=fused_conv_bn)})

        final_channels = sizes[-1]
        self.final: tp.Optional[nn.Module] = None
        if linear_out:
            self.final = nn.ConvTranspose1d(final_channels, out_channels, 1)
        elif complex_out:
            self.final = nn.Sequential(
                nn.Conv1d(final_channels, 2 * final_channels, 1), act(),
                nn.ConvTranspose1d(2 * final_channels, out_channels, 1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every weight from `generator` (drawn on the CPU):
        LeCun-normal convs with zero bias, N(0, 1/pos_dim) merger heads,
        N(0, 1/C_in) subject matrices, BatchNorm at identity."""
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
                init_conv_(module, generator)
            elif isinstance(module, nn.BatchNorm1d):
                module.reset_parameters()
            elif isinstance(module, (ChannelMerger, SubjectLayers)):
                module.reset_parameters(generator)

    def forward(self, inputs: tp.Mapping[str, torch.Tensor],
                subject_index: torch.Tensor, positions: torch.Tensor,
                pos_emb: tp.Optional[torch.Tensor] = None,
                rec_index: tp.Optional[torch.Tensor] = None,
                rec_positions: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None,
                with_penalty: bool = False):
        """inputs {'meg': [B, C, T]}, subject_index [B], positions
        [B, C, 2]; pos_emb/rec_index/rec_positions, and the dropout's
        generator, as in ChannelMerger.attention.
        Returns [B, out_channels, T] fp32, or with `with_penalty` that and
        the train-mode merger usage penalty (a scalar, 0 in eval)."""
        if self.training:
            for name in ("conv_dropout", "dropout_input"):
                if getattr(self, name):
                    # nn.Dropout draws from torch's global generator
                    raise NotImplementedError(
                        f"simpleconv.{name}={getattr(self, name)!r} in "
                        f"train mode")
        meg = inputs["meg"]
        length = meg.shape[-1]
        penalty = torch.zeros((), device=meg.device)
        if self.merger is not None:
            weights = self.merger.attention(
                positions, pos_emb=pos_emb, rec_index=rec_index,
                rec_positions=rec_positions, generator=generator)
            meg = torch.einsum("bct,boc->bot", meg, weights)
            if self.training and self.merger_penalty > 0:
                penalty = self.merger.penalty(weights)
        if self.initial_linear is not None:
            meg = self.initial_linear(meg)
        if self.subject_layers is not None:
            meg = self.subject_layers(meg, subject_index)
        x = self.encoders["meg"](meg)
        if self.final is not None:
            x = self.final(x)
        x = x[..., :length]
        return (x, penalty) if with_penalty else x
