"""SimpleConv, the paper's brain decoder.

Port of ``brainmagick_tpu/models/simpleconv.py``. Forward pipeline: a
fixed subset of the sensors (``subsample_meg_channels``, the others
zeroed) -> ChannelDropout (``dropout``; padded sensors zeroed in eval mode
too) -> ChannelMerger spatial attention (heads shared, or one set a
subject with ``merger_per_subject``) -> initial 1x1 conv stack ->
per-subject SubjectLayers -> the spectrogram branch (``n_fft``:
each channel's Hann-window rfft bins become channels over frames of hop
n_fft / 2) -> the subject embedding (``subject_dim``) -> a dilated
ConvSequence encoder per input (the MEG, and in the encode task the
features, whose branch skips the MEG's head; a model may have no MEG
input), or one over the concatenated inputs (``concatenate``) -> the
DualPathRNN (``dual_path``) -> final (linear / complex) head over the
encoders' concatenated outputs, 1x1, or with ``n_fft`` a strided
transposed conv back to the samples -> crop to the input length.
Layout [B, C, T] in and [B, F, T] out, as the flax module's public call,
or [B, T, F] with ``output_layout="btc"``. With `fused_head` the merger,
the initial conv and the subject layers run as one gathered matrix per
recording (``_fused_head``), on the subset's MEG.

The constructor takes the flax module's keyword arguments and keeps them
as attributes of the same names, so ``brainmagick_tpu.convert
.simpleconv_rules`` reads this module as it reads the flax one. Three of
those names are submodules here, because the reference key layout puts
weights under them: ``merger``, ``initial_linear`` and ``subject_layers``
hold the module when the option is on and None when it is off (the rules
only test them for truth); the embedding is ``subject_embedding``.
``conv_impl`` other than "conv" (a TPU-only lowering) raises
NotImplementedError naming the option. In train mode ChannelDropout's
and the merger's disks and the encoders' dropout masks
(``dropout_input``, ``conv_dropout``) are drawn from the `generator`
passed to ``forward``, or replayed from the `centers` and `masks` it is
given, and ``fused_conv_bn`` runs the encoders' conv + BatchNorm layers
through ``ops.conv_bn.conv_stats``.
`dtype` ('bfloat16') is the compute dtype of the convs, the merger's
contractions and the fused head (parameters and statistics stay fp32,
see ``models.common``); `output_dtype` that of the estimate (fp32 when
None).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..precision import einsum_fp32, torch_dtype
from .common import (ChannelDropout, ChannelMerger, Conv1d, ConvSequence,
                     ConvTranspose1d, DualPathRNN, LayerScale,
                     ScaledEmbedding, SubjectLayers, get_activation,
                     init_conv_)

#: the seed of the fixed sensor subset of ``subsample_meg_channels``
SUBSAMPLE_SEED = 1234


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
        if conv_impl != "conv":
            # the shifted-matmul lowerings are a TPU workaround
            raise NotImplementedError(f"simpleconv.conv_impl={conv_impl!r}")
        if set(in_channels) != set(hidden):
            raise ValueError(f"in_channels and hidden keys must match "
                             f"({set(in_channels)} vs {set(hidden)})")
        if output_layout not in ("bct", "btc"):
            raise ValueError(f"output_layout={output_layout!r}: 'bct' or "
                             f"'btc'")
        if linear_out and complex_out:
            raise ValueError("linear_out and complex_out are exclusive")
        use_final = linear_out or complex_out
        if not use_final and len(in_channels) > 1 and not concatenate:
            raise ValueError("without a linear or complex head there must "
                             "be a single branch")
        if n_fft is not None and not use_final:
            raise ValueError(f"simpleconv.n_fft={n_fft}: the spectrogram "
                             f"branch needs linear_out or complex_out")
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
        self.initial_nonlin = initial_nonlin
        self.dtype = dtype
        self.output_dtype = output_dtype
        self.bn_conv_bias = bn_conv_bias
        self.fused_head = fused_head
        self.concatenate = concatenate
        self.subject_dim = subject_dim
        self.subsample_meg_channels = subsample_meg_channels
        self.post_skip = post_skip
        self.scale = scale
        self.rewrite = rewrite
        self.dropout = dropout
        self.dropout_rescale = dropout_rescale
        self.output_layout = output_layout
        self.dual_path = dual_path
        self.n_fft = n_fft
        self.fft_complex = fft_complex
        self.merger_per_subject = merger_per_subject
        mask = None
        if subsample_meg_channels and "meg" in in_channels:
            # the flax module's fixed sensor subset, [C_in, 1]: a constant
            # that moves with the model and stays out of the state dict
            mask = np.zeros((in_channels["meg"], 1), np.float32)
            order = np.random.RandomState(SUBSAMPLE_SEED).permutation(
                in_channels["meg"])
            mask[order[:subsample_meg_channels]] = 1.
            mask = torch.from_numpy(mask)
        self.register_buffer("meg_mask", mask, persistent=False)
        self.conv_impl = conv_impl
        dt = torch_dtype(dtype)
        self.compute_dtype = dt
        self.estimate_dtype = torch_dtype(output_dtype) or torch.float32

        act = get_activation(gelu, relu_leakiness, gelu_exact)
        # the MEG's head (flax builds it only for a 'meg' input)
        has_meg = "meg" in in_channels
        chin = in_channels.get("meg", 0)
        self.channel_dropout = None
        if dropout and has_meg:
            self.channel_dropout = ChannelDropout(dropout, dropout_rescale)
        self.merger = None
        if merger and has_meg:
            # merger_dropout and merger_penalty act only in training
            self.merger = ChannelMerger(
                merger_channels, pos_dim=merger_pos_dim,
                dropout=merger_dropout, usage_penalty=merger_penalty,
                n_subjects=n_subjects, per_subject=merger_per_subject)
            chin = merger_channels
        self.initial_linear = None
        if initial_linear and has_meg:
            # reference layout: conv at 2 d, activation between convs
            layers: tp.List[nn.Module] = [
                Conv1d(chin, initial_linear, 1, compute_dtype=dt)]
            for _ in range(initial_depth - 1):
                layers += [act(), Conv1d(initial_linear, initial_linear, 1,
                                         compute_dtype=dt)]
            if initial_nonlin:
                layers.append(act())
            self.initial_linear = nn.Sequential(*layers)
            chin = initial_linear
        self.subject_layers = None
        if subject_layers and has_meg:
            dim = {"hidden": hidden["meg"], "input": chin}[subject_layers_dim]
            self.subject_layers = SubjectLayers(chin, dim, n_subjects,
                                                subject_layers_id)
            chin = dim
        if n_fft is not None and has_meg:
            chin *= (n_fft // 2 + 1) * (2 if fft_complex else 1)
        self.subject_embedding = None
        if subject_dim and has_meg:
            self.subject_embedding = ScaledEmbedding(n_subjects, subject_dim,
                                                     embedding_scale)
            chin += subject_dim

        channels = dict(in_channels)
        if has_meg:
            channels["meg"] = chin
        hidden = dict(hidden)
        if concatenate:
            channels = {"concat": sum(channels.values())}
            hidden = {"concat": sum(hidden.values())}
        sizes = {name: [channels[name]] + [int(round(hidden[name]
                                                     * growth ** k))
                                           for k in range(depth)]
                 for name in sorted(channels)}
        final_channels = sum(s[-1] for s in sizes.values())
        if not use_final:
            sizes[next(iter(sizes))][-1] = out_channels
        self.encoders = nn.ModuleDict({name: ConvSequence(
            size, kernel=kernel_size, dilation_growth=dilation_growth,
            dilation_period=dilation_period, dropout=conv_dropout,
            leakiness=relu_leakiness, groups=groups, batch_norm=batch_norm,
            dropout_input=dropout_input, skip=skip, scale=scale,
            rewrite=rewrite, post_skip=post_skip,
            activation_on_last=use_final, glu=glu, glu_context=glu_context,
            glu_glu=glu_glu, activation=act, fused_conv_bn=fused_conv_bn,
            bn_conv_bias=bn_conv_bias, compute_dtype=dt)
            for name, size in sizes.items()})

        self.dual_path_rnn = None
        if dual_path:
            self.dual_path_rnn = DualPathRNN(final_channels, dual_path)

        # the head; with the spectrogram branch a transposed conv that
        # undoes its hop, padded as flax's nn.ConvTranspose pads
        # ((n_fft // 4, n_fft // 4) of the stride-dilated input: torch's
        # padding kernel - 1 - n_fft // 4)
        kernel, stride, pad = 1, 1, 0
        if n_fft is not None:
            kernel, stride, pad = n_fft, n_fft // 2, n_fft - 1 - n_fft // 4
        head = dict(stride=stride, padding=pad, compute_dtype=dt)
        self.final: tp.Optional[nn.Module] = None
        if linear_out:
            self.final = ConvTranspose1d(final_channels, out_channels,
                                         kernel, **head)
        elif complex_out:
            self.final = nn.Sequential(
                Conv1d(final_channels, 2 * final_channels, 1,
                       compute_dtype=dt), act(),
                ConvTranspose1d(2 * final_channels, out_channels, kernel,
                                **head))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every weight from `generator` (drawn on the CPU):
        LeCun-normal convs with zero bias, N(0, 1/pos_dim) merger heads,
        N(0, 1/C_in) subject matrices, N(0, 1/scale^2) subject embeddings,
        BatchNorm at identity, LayerScale at init / boost, the DualPathRNN's
        LSTMs as flax's OptimizedLSTMCell (LeCun-normal input kernels,
        orthogonal recurrent kernels, zero biases)."""
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
                init_conv_(module, generator)
            elif isinstance(module, (nn.BatchNorm1d, LayerScale)):
                module.reset_parameters()
            elif isinstance(module, (ChannelMerger, SubjectLayers,
                                     ScaledEmbedding, DualPathRNN)):
                module.reset_parameters(generator)

    def _fused_head(self, meg: torch.Tensor, positions: torch.Tensor,
                    pos_emb: torch.Tensor, rec_index: torch.Tensor,
                    rec_positions: torch.Tensor, rec_subjects: torch.Tensor,
                    generator: tp.Optional[torch.Generator],
                    center: tp.Optional[torch.Tensor]) -> torch.Tensor:
        """The merger's mix, the initial 1x1 conv and the subject matrix
        as one gathered [C_in, dim] matrix per recording (the flax
        module's ``_fused_head``): by associativity on the same
        parameters, ((x A_r^T) W1 + b1) S_s = x (A_r^T W1 S_s) + b1 S_s,
        with S_s the subject matrix of recording r's subject
        ``rec_subjects[r]``. W1 and b1 are rounded to the compute dtype,
        as the flax module reads them through the conv, then the operands
        are cast to meg's dtype and contracted with an fp32 accumulator;
        the result [B, dim, T] is fp32."""
        cd = meg.dtype
        attention = self.merger.attention(
            positions, pos_emb, rec_index, rec_positions, generator, center,
            dtype=cd, gather=False)                            # [R, O_m, C]
        conv = self.initial_linear[0]
        wd = self.compute_dtype or conv.weight.dtype
        w1 = conv.weight[:, :, 0].t().to(wd)                   # [O_m, O1]
        subj = self.subject_layers.weights[rec_subjects]       # [R, O1, D]
        t1 = einsum_fp32("roc,ok->rck", attention, w1, dtype=cd)
        fold = einsum_fp32("rck,rkd->rcd", t1, subj, dtype=cd)
        bias = einsum_fp32("k,rkd->rd", conv.bias.to(wd), subj)
        out = einsum_fp32("bct,bcd->bdt", meg, fold[rec_index], dtype=cd)
        return out + bias[rec_index][:, :, None]

    def _stft(self, meg: torch.Tensor) -> torch.Tensor:
        """The spectrogram branch, as the flax module's ``_stft``: [B, C, T]
        -> [B, C F (2), T'] with F = n_fft // 2 + 1 bins and T' frames of
        hop n_fft // 2. Each sensor zero-padded on the right to a multiple
        of the hop, reflect-padded by n_fft // 4 and then by n_fft // 2
        on both sides; Hann frames (``np.hanning(n_fft + 1)[:-1]``), whose
        rfft is divided by the window's norm; with `fft_complex` the real
        and imaginary parts of each bin side by side, else its modulus;
        the channel index (sensor, bin, part)."""
        n_fft, hop = self.n_fft, self.n_fft // 2
        batch = meg.shape[0]
        window = torch.from_numpy(
            np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(meg.device)
        # [B, C, T] throughout: CUDA's reflect padding takes at most 65,535
        # rows a batch entry, fewer than B x C at the paper's width
        x = F.pad(meg, (0, -meg.shape[-1] % hop))
        x = F.pad(x, (n_fft // 4, n_fft // 4), mode="reflect")
        x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
        frames = x.unfold(-1, n_fft, hop) * window         # [B, C, T', n]
        spec = torch.fft.rfft(frames, dim=-1)
        norm = torch.sqrt(torch.sum(window ** 2))
        if self.fft_complex:
            z = torch.stack([spec.real, spec.imag], dim=-1) / norm
        else:
            z = (spec.abs() / norm)[..., None]
        n_frames = z.shape[2]
        z = z.flatten(3).permute(0, 2, 1, 3)               # [B, T', C, F(2)]
        return z.reshape(batch, n_frames, -1).transpose(1, 2)

    def _meg_head(self, meg: torch.Tensor, subject_index: torch.Tensor,
                  positions: torch.Tensor,
                  pos_emb: tp.Optional[torch.Tensor],
                  rec_index: tp.Optional[torch.Tensor],
                  rec_positions: tp.Optional[torch.Tensor],
                  rec_subjects: tp.Optional[torch.Tensor],
                  generator: tp.Optional[torch.Generator],
                  centers: tp.Optional[tp.Iterator[torch.Tensor]]
                  ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """The MEG's branch before its encoder: (meg, the merger's usage
        penalty); the arguments as ``forward``'s."""
        if self.meg_mask is not None:
            # an fp32 constant, as in the flax module: a bf16 meg comes out
            # fp32
            meg = meg * self.meg_mask
        if self.channel_dropout is not None:
            center = None
            if centers is not None and self.training:
                center = next(centers)
            meg = self.channel_dropout(meg, positions, generator, center)
        merger_center = None
        if centers is not None and self.training and self.merger is not None \
                and self.merger.dropout:
            merger_center = next(centers)
        penalty = torch.zeros((), device=meg.device)
        fused_head = (
            self.fused_head and self.merger is not None
            and self.initial_linear is not None
            and self.subject_layers is not None and self.initial_depth == 1
            and not self.initial_nonlin and not self.merger_per_subject
            and self.merger_penalty == 0
            and pos_emb is not None and rec_index is not None
            and rec_subjects is not None)
        if fused_head:
            meg = self._fused_head(meg, positions, pos_emb, rec_index,
                                   rec_positions, rec_subjects, generator,
                                   merger_center)
        else:
            if self.merger is not None:
                weights = self.merger.attention(
                    positions, pos_emb=pos_emb, rec_index=rec_index,
                    rec_positions=rec_positions, generator=generator,
                    center=merger_center, dtype=meg.dtype,
                    subjects=subject_index)
                meg = einsum_fp32("bct,boc->bot", meg, weights,
                                  dtype=meg.dtype)
                if self.training and self.merger_penalty > 0:
                    penalty = self.merger.penalty(weights)
            if self.initial_linear is not None:
                meg = self.initial_linear(meg)
            if self.subject_layers is not None:
                meg = self.subject_layers(meg, subject_index)
        if self.n_fft is not None:
            meg = self._stft(meg)
        # torch.cat promotes mixed types as jnp.concatenate does
        if self.subject_embedding is not None:
            emb = self.subject_embedding(subject_index)[:, :, None]
            meg = torch.cat([meg, emb.expand(-1, -1, meg.shape[-1])], dim=1)
        return meg, penalty

    def forward(self, inputs: tp.Mapping[str, torch.Tensor],
                subject_index: torch.Tensor, positions: torch.Tensor,
                pos_emb: tp.Optional[torch.Tensor] = None,
                rec_index: tp.Optional[torch.Tensor] = None,
                rec_positions: tp.Optional[torch.Tensor] = None,
                rec_subjects: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None,
                with_penalty: bool = False,
                centers: tp.Optional[tp.Iterable[torch.Tensor]] = None,
                masks: tp.Optional[tp.Iterable[torch.Tensor]] = None):
        """inputs {'meg': [B, C, T]} (and 'features' [B, F, T] in the
        encode task; or no 'meg'), subject_index [B], positions [B, C, 2];
        pos_emb/rec_index/rec_positions, and the dropout's generator, as in
        ChannelMerger.attention (per-subject heads take a per-sample
        pos_emb and subject_index); rec_subjects [R], each
        recording's subject, for the fused head, which engages as the flax
        module's does: with `fused_head`, the merger, one initial conv with
        no activation after it, the subject layers, no merger penalty, and
        the per-recording arrays given; otherwise the unfused ops run.
        In train mode, `centers` replays the disk centres (ChannelDropout's,
        then the merger's) and `masks` the encoders' dropout masks
        ([B, C, T] each, the encoders in sorted order), in the order the
        flax module draws them, in place of draws from `generator`.
        Returns [B, out_channels, T] ([B, T, out_channels] with
        ``output_layout="btc"``) in `output_dtype` (fp32 when None), or
        with `with_penalty` that and the train-mode merger usage penalty (a
        scalar, 0 in eval)."""
        length = next(iter(inputs.values())).shape[-1]
        centers = None if centers is None else iter(centers)
        masks = None if masks is None else iter(masks)
        if self.compute_dtype is not None:
            inputs = {name: x.to(self.compute_dtype)
                      for name, x in inputs.items()}
        penalty = torch.zeros((), device=next(iter(inputs.values())).device)
        if "meg" in inputs:
            meg, penalty = self._meg_head(
                inputs["meg"], subject_index, positions, pos_emb, rec_index,
                rec_positions, rec_subjects, generator, centers)
            inputs = {**inputs, "meg": meg}
        if self.concatenate:
            inputs = {"concat": torch.cat(
                [inputs[name] for name in sorted(inputs)], dim=1)}
        x = torch.cat([self.encoders[name](inputs[name], generator, masks)
                       for name in sorted(inputs)], dim=1)
        if self.dual_path_rnn is not None:
            x = self.dual_path_rnn(x)
        if self.final is not None:
            x = self.final(x)
        x = x[..., :length].to(self.estimate_dtype)
        if self.output_layout == "btc":
            x = x.transpose(1, 2)
        return (x, penalty) if with_penalty else x
