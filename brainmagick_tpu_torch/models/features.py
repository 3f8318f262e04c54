"""Feature models: trainable speech-side encoders applied to the ground
truth before the loss.

Port of ``brainmagick_tpu/models/features.py``. ``DeepMel`` is one
``ConvSequence`` over mel-spectrogram features (the reference's DeepMel
is a ConvSequence too): hidden 320 x 10 layers to 768 outputs, kernel 3,
dilation growth 2 with period 5, BatchNorm, skips, a GLU every 2 layers
with context 1, ReLU, no activation on the last layer. Its convs are
plain ``Conv1d`` layers (the JAX DeepMel builds its ConvSequence without
``fused_conv_bn``) and it computes in fp32. With a `stride`, each layer's
conv steps by it (padded ``kernel // 2 * dilation`` a side, as flax's),
so no layer keeps its input's shape and none adds its skip; the GLU convs
do not stride. The targets then come out shorter than the estimate, and
the solver refuses them where the JAX package's loss fails on them.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .common import ConvSequence, init_conv_


class DeepMel(ConvSequence):
    """[B, F, T] mel features -> [B, n_out_channels, T'] fp32 (T' = T at
    stride 1).

    The constructor takes the flax module's fields but ``dtype`` (the
    port's DeepMel computes in fp32, as the JAX package builds it) and
    keeps the widths and the stride as attributes of the same names."""

    def __init__(self, n_in_channels: int, n_hidden_channels: int = 320,
                 n_hidden_layers: int = 10, n_out_channels: int = 768,
                 kernel: int = 3, stride: int = 1, dilation_growth: int = 2,
                 dilation_period: tp.Optional[int] = 5,
                 batch_norm: bool = True, activation_on_last: bool = False,
                 skip: bool = True, glu: int = 2,
                 glu_context: int = 1) -> None:
        channels = ([n_in_channels] + [n_hidden_channels]
                    * (n_hidden_layers - 1) + [n_out_channels])
        super().__init__(channels, kernel=kernel, stride=stride,
                         dilation_growth=dilation_growth,
                         dilation_period=dilation_period,
                         batch_norm=batch_norm, skip=skip,
                         activation_on_last=activation_on_last, glu=glu,
                         glu_context=glu_context)
        self.n_in_channels = n_in_channels
        self.n_hidden_channels = n_hidden_channels
        self.n_hidden_layers = n_hidden_layers
        self.n_out_channels = n_out_channels
        self.stride = stride

    def reset_parameters(self, generator: torch.Generator) -> None:
        """LeCun-normal convs with zero bias drawn from `generator` (on
        the CPU), BatchNorm at identity."""
        for module in self.modules():
            if isinstance(module, nn.Conv1d):
                init_conv_(module, generator)
            elif isinstance(module, nn.BatchNorm1d):
                module.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).float()
