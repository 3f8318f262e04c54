"""Shared model blocks: subject layers and embeddings, spatial attention
over sensor positions (heads shared or per subject), the spatial channel
dropout, dilated conv stacks (strided, and transposed for a decoder) with
LayerScale and the rewrite and post-skip 1x1 convs, the LSTM cells of
flax's ``OptimizedLSTMCell`` stacked into one ``torch.lstm`` call, and
the DualPathRNN over them, in eval and train mode.

Port of ``brainmagick_tpu/models/common.py`` in torch's natural [B, C, T]
Conv1d layout. Submodules carry the reference ``bm`` names
(``sequence.{k}.{i}``, ``glus.{k}.0``, ``heads``, ``weights``), which are
the keys ``brainmagick_tpu.convert`` maps flax leaves onto. Train mode
follows flax: BatchNorm normalizes with the biased batch variance and
keeps it in its running average, and every random draw of train mode
(the merger's and ChannelDropout's disk centres, the conv stacks' dropout
masks) comes from an explicit ``torch.Generator``, or is one the caller
passes (the tests replay flax's draws so).

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


class _SameConv(torch.autograd.Function):
    """A stride-1, ungrouped conv1d with SAME padding whose input gradient
    is the forward conv of the output's gradient with the weights'
    channels swapped and their taps reversed, as ``ops.conv_bn``'s
    backward computes it: the train step runs cuDNN's deterministic
    algorithms only (``precision.deterministic_cudnn``), and among them
    backward-data at the encoder's dilated shapes is an order of magnitude
    slower than a forward conv. The weights' gradient is cuDNN's
    backward-filter, the bias's the sum of the output's gradient."""

    @staticmethod
    def forward(ctx, x, w, b, padding: int, dilation: int):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.dilation = padding, dilation
        ctx.has_bias = b is not None
        return F.conv1d(x, w, b, padding=padding, dilation=dilation)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        pad, d = ctx.padding, ctx.dilation
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = F.conv1d(dy, w.transpose(0, 1).flip(2), padding=pad,
                          dilation=d)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(x, w.shape, dy, padding=pad,
                                             dilation=d)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2))
        return dx, dw, db, None, None


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with flax ``nn.Conv``'s `compute_dtype` (``dtype=``):
    input, weight and bias cast to it at use, the result in it; with None,
    ``nn.Conv1d`` itself on an input of the weights' type, else flax's
    ``dtype=None`` rule: the input and the weights promoted to one type
    (a bf16 input meets fp32 weights in fp32). The parameters stay
    fp32. A stride-1, ungrouped conv with an odd kernel and SAME padding
    (the encoder's) runs through ``_SameConv`` where autograd records it,
    so that its input gradient is a forward conv; every other conv, and
    every conv without a gradient, is ``nn.Conv1d``'s."""

    def __init__(self, *args, compute_dtype: tp.Optional[torch.dtype] = None,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        k, = self.kernel_size
        self._same = (self.stride == (1,) and self.groups == 1 and k % 2
                      and self.padding_mode == "zeros"
                      and self.padding == (self.dilation[0] * (k // 2),))

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: tp.Optional[torch.Tensor]) -> torch.Tensor:
        if self._same and torch.is_grad_enabled() and (
                x.requires_grad or weight.requires_grad):
            return _SameConv.apply(x, weight, bias, self.padding[0],
                                   self.dilation[0])
        return super()._conv_forward(x, weight, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None and x.dtype == self.weight.dtype:
            return super().forward(x)
        if dt is None:
            dt = torch.promote_types(x.dtype, self.weight.dtype)
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
        return einsum_fp32("bct,bcd->bdt", x, self.weights[subjects])


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


class Dropout(nn.Module):
    """flax ``nn.Dropout`` on an explicit generator: in train mode each
    element is kept with probability ``1 - rate`` and the kept ones are
    divided by that probability in the input's own type (a bf16 input
    rounds in bf16, as flax's ``inputs / keep_prob`` does: the probability
    rounded to the input's type, then the division). The keep mask is the
    `mask` given (bool, the input's shape), else drawn from `generator`
    (uniforms below the keep probability, drawn on the generator's device);
    with neither, train mode raises. Eval mode, or a rate of 0, returns
    the input."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: tp.Optional[torch.Generator] = None,
                mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or not self.rate:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        if mask is None:
            if generator is None:
                raise ValueError("dropout in train mode needs a generator "
                                 "or a mask")
            mask = torch.rand(x.shape, generator=generator,
                              device=generator.device) < keep
        # a divisor on the input's device: a CPU scalar would turn the
        # division into a product by its reciprocal on CUDA
        divisor = torch.full((), keep, dtype=x.dtype, device=x.device)
        return torch.where(mask.to(x.device), x / divisor,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def run_layers(modules: tp.Iterable[nn.Module], x: torch.Tensor,
               generator: tp.Optional[torch.Generator] = None,
               masks: tp.Optional[tp.Iterator[torch.Tensor]] = None
               ) -> torch.Tensor:
    """`modules` in turn on `x`, each ``Dropout`` with `generator` and the
    next of `masks` when given."""
    for module in modules:
        if isinstance(module, Dropout):
            mask = None
            if masks is not None and module.training and module.rate:
                mask = next(masks)
            x = module(x, generator, mask)
        else:
            x = module(x)
    return x


def _disk_keep_probability(positions: torch.Tensor, radius: float,
                           grid: int = 10) -> torch.Tensor:
    """P(a centre uniform in [0, 1]^2 lies farther than `radius` from each
    position), by the midpoint rule on a `grid` x `grid` lattice: [..., 2]
    -> [...] in the positions' type."""
    steps = (torch.arange(grid, dtype=positions.dtype,
                          device=positions.device) + 0.5) / grid
    cx, cy = torch.meshgrid(steps, steps, indexing="ij")
    centers = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)
    dist = torch.linalg.vector_norm(positions[..., None, :] - centers,
                                    dim=-1)
    return (dist > radius).to(positions.dtype).mean(dim=-1)


class ChannelDropout(nn.Module):
    """Spatial dropout of train mode: every sensor within `dropout` of a
    disk centre uniform in [0, 1]^2 is zeroed, and with `rescale` each
    sensor is divided by its keep probability (``_disk_keep_probability``).
    Invalid (padded) sensors are zeroed in eval mode too. The centre is
    the one given, else drawn from `generator` in the meg's type."""

    def __init__(self, dropout: float = 0.1, rescale: bool = True) -> None:
        super().__init__()
        self.dropout = dropout
        self.rescale = rescale

    def forward(self, meg: torch.Tensor, positions: torch.Tensor,
                generator: tp.Optional[torch.Generator] = None,
                center: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """meg [B, C, T], positions [B, C, 2] -> [B, C, T]; a rescaled
        meg takes the positions' type, as in flax."""
        if not self.dropout:
            return meg
        valid = ~is_invalid_position(positions)
        meg = meg * valid[:, :, None]
        if not self.training:
            return meg
        if center is None:
            if generator is None:
                raise ValueError("channel dropout in train mode needs a "
                                 "generator or a disk centre")
            center = torch.rand(2, generator=generator,
                                device=generator.device, dtype=meg.dtype)
        dist = torch.linalg.vector_norm(
            positions - center.to(positions.device), dim=-1)   # [B, C]
        meg = meg * (dist > self.dropout)[:, :, None]
        if self.rescale:
            kept = _disk_keep_probability(positions, self.dropout)
            meg = meg / (1e-8 + kept[:, :, None])
        return meg


class LayerScale(nn.Module):
    """Diagonal rescaling of a residual branch, with a learning-rate
    boost: the parameter starts at ``init / boost`` and the forward is
    ``boost * scale * x`` (a bf16 x comes out fp32, as in flax)."""

    def __init__(self, channels: int, init: float = 0.1,
                 boost: float = 5.) -> None:
        super().__init__()
        self.init = init
        self.boost = boost
        self.scale = nn.Parameter(torch.empty(channels))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(self.init / self.boost)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.boost * self.scale)[:, None] * x


class ChannelMerger(nn.Module):
    """Spatial attention over sensors: learned heads attend over Fourier
    embeddings of sensor positions and merge C input channels into
    `chout` virtual channels. Invalid (padded) sensors, and in train mode
    every sensor within `dropout` of a random disk centre, get -inf
    before the softmax; a row whose every sensor is masked gets the finite
    softmax of its raw scores instead of NaN. With `per_subject` the heads
    are one [chout, pos_dim] matrix per subject ([n_subjects, chout,
    pos_dim]), gathered by each sample's subject, and the attention is per
    sample."""

    def __init__(self, chout: int, pos_dim: int = 256, dropout: float = 0.,
                 usage_penalty: float = 0., n_subjects: int = 200,
                 per_subject: bool = False) -> None:
        super().__init__()
        if pos_dim % 4:
            raise ValueError(f"pos_dim must be a multiple of 4, got {pos_dim}")
        self.pos_dim = pos_dim
        self.dropout = dropout
        self.usage_penalty = usage_penalty
        self.per_subject = per_subject
        shape = (n_subjects, chout, pos_dim) if per_subject else (chout,
                                                                   pos_dim)
        self.heads = nn.Parameter(torch.empty(shape))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.heads, self.pos_dim ** -0.5, generator)

    def attention(self, positions: torch.Tensor,
                  pos_emb: tp.Optional[torch.Tensor] = None,
                  rec_index: tp.Optional[torch.Tensor] = None,
                  rec_positions: tp.Optional[torch.Tensor] = None,
                  generator: tp.Optional[torch.Generator] = None,
                  center: tp.Optional[torch.Tensor] = None,
                  dtype: tp.Optional[torch.dtype] = None,
                  gather: bool = True,
                  subjects: tp.Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """Softmax weights [B, chout, C] over the sensors, fp32.

        pos_emb is either [B, C, D] per sample, or [R, C, D] per
        recording together with rec_index [B] and rec_positions
        [R, C, 2]: then R softmax rows are computed instead of B, and
        returned as they are, [R, chout, C], when not `gather`. Per-subject
        heads take the heads of `subjects` [B] and a per-sample pos_emb
        (the per-recording arrays are not read). The scores contract in
        `dtype` (the meg's) with an fp32 accumulator. In train mode with
        dropout, the disk centre is `center` ([2]) when given, else drawn
        uniformly in [0, 1)^2 from `generator`."""
        per_recording = (rec_index is not None and pos_emb is not None
                         and not self.per_subject)
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
        if self.per_subject:
            if subjects is None:
                raise ValueError("per-subject heads need the subjects")
            scores = einsum_fp32("bcd,bod->boc", embedding,
                                 self.heads[subjects], dtype=dtype)
        else:
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
                center: tp.Optional[torch.Tensor] = None,
                subjects: tp.Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """meg [B, C, T], positions [B, C, 2] -> [B, chout, T] fp32,
        contracted in meg's dtype with an fp32 accumulator; the other
        arguments as in `attention`."""
        weights = self.attention(positions, pos_emb, rec_index,
                                 rec_positions, generator, center,
                                 dtype=meg.dtype, subjects=subjects)
        return einsum_fp32("bct,boc->bot", meg, weights, dtype=meg.dtype)


#: flax OptimizedLSTMCell's gates, in torch's order of the LSTM weights
GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """The parameters of one flax ``OptimizedLSTMCell``: per gate an input
    kernel ``input[g]`` [H, C_in] without bias and a recurrent kernel
    ``hidden[g]`` [H, H] with the gate's one bias ``bias[g]`` [H]."""

    def __init__(self, input_size: int, hidden_size: int) -> None:
        super().__init__()
        self.input = nn.ParameterDict({
            g: nn.Parameter(torch.empty(hidden_size, input_size))
            for g in GATES})
        self.hidden = nn.ParameterDict({
            g: nn.Parameter(torch.empty(hidden_size, hidden_size))
            for g in GATES})
        self.bias = nn.ParameterDict({
            g: nn.Parameter(torch.empty(hidden_size)) for g in GATES})

    def reset_parameters(self, generator: torch.Generator) -> None:
        for g in GATES:
            weight = self.input[g]
            lecun_normal_(weight, weight.shape[1], generator)
            with torch.no_grad():
                self.hidden[g].copy_(nn.init.orthogonal_(
                    torch.empty(self.hidden[g].shape), generator=generator))
            nn.init.zeros_(self.bias[g])

    def weights(self, zero_bias: torch.Tensor) -> tp.List[torch.Tensor]:
        """torch.lstm's four tensors of this cell: the stacked input and
        recurrent kernels, a zero input bias and the cell's bias."""
        return [torch.cat([self.input[g] for g in GATES]),
                torch.cat([self.hidden[g] for g in GATES]), zero_bias,
                torch.cat([self.bias[g] for g in GATES])]


class StackedLSTM(nn.Module):
    """`num_layers` LSTMs over [B, T, C], zero initial state. Bidirectional:
    each layer's forward and backward LSTM read the layer's input and
    their outputs are concatenated, and ``linear`` maps 2H back to H after
    the stack. ``cells[j]`` is flax's ``OptimizedLSTMCell_{j}``: layer l's
    forward LSTM is cell l (2 l when bidirectional, its backward one
    2 l + 1).

    The stack runs as one ``torch.lstm`` call (cuDNN on the card) whose
    input biases are zeros outside the graph, so each gate trains one
    bias as in flax (``nn.LSTM`` would train two, and Adam would move
    their sum twice as fast)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        directions = 2 if bidirectional else 1
        self.cells = nn.ModuleList([
            LSTMCell(input_size if layer == 0 else directions * hidden_size,
                     hidden_size)
            for layer in range(num_layers) for _ in range(directions)])
        self.linear = (nn.Linear(2 * hidden_size, hidden_size)
                       if bidirectional else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for cell in self.cells:
            cell.reset_parameters(generator)
        if self.linear is not None:
            lecun_normal_(self.linear.weight, self.linear.weight.shape[1],
                          generator)
            nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] -> [B, T, H]."""
        directions = 2 if self.bidirectional else 1
        state = x.new_zeros(self.num_layers * directions, x.shape[0],
                            self.hidden_size)
        zero_bias = x.new_zeros(4 * self.hidden_size)
        weights = [w for cell in self.cells for w in cell.weights(zero_bias)]
        out, _, _ = torch.lstm(x, (state, state), weights, True,
                               self.num_layers, 0.0, self.training,
                               self.bidirectional, True)
        if self.linear is not None:
            out = self.linear(out)
        return out


class DualPathRNN(nn.Module):
    """Interleaved intra- and inter-chunk LSTMs over [B, C, T], as flax's
    ``DualPathRNN``: T padded on the right with zeros to a multiple of
    `inner_length`, then ``4 depth`` single-layer LSTMs of C hidden units
    (``lstms[i]``, flax's ``RNN_{i}``), the even ones over each chunk of
    `inner_length` steps, the odd ones over the chunks' same offsets
    (sequences of T / `inner_length` steps), each added to its input,
    and the time axis reversed after every odd one; the first T steps are
    returned. Each LSTM is one ``torch.lstm`` call (``StackedLSTM``). The
    LSTMs compute in fp32: a bf16 input meets their fp32 weights in fp32,
    as in flax, and the result is fp32."""

    def __init__(self, channels: int, depth: int,
                 inner_length: int = 10) -> None:
        super().__init__()
        self.inner_length = inner_length
        self.lstms = nn.ModuleList([StackedLSTM(channels, channels, 1)
                                    for _ in range(4 * depth)])

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lstm in self.lstms:
            lstm.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, channels, length = x.shape
        inner = self.inner_length
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = F.pad(x, (0, -length % inner)).transpose(1, 2)     # [B, T', C]
        chunks = x.shape[1] // inner
        for idx, lstm in enumerate(self.lstms):
            if idx % 2 == 0:
                y = lstm(x.reshape(batch * chunks, inner, channels))
                y = y.reshape(batch, chunks * inner, channels)
            else:
                y = x.reshape(batch, chunks, inner, channels).transpose(1, 2)
                y = lstm(y.reshape(batch * inner, chunks, channels))
                y = y.reshape(batch, inner, chunks, channels).transpose(1, 2)
                y = y.reshape(batch, chunks * inner, channels)
            x = x + y
            if idx % 2 == 1:
                x = x.flip(1)
        return x[:, :length].transpose(1, 2)


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
    """Stack of dilated 1D convs with BatchNorm, activation, dropout,
    residual skips and interleaved GLU gates. Layer k is ``sequence[k]``,
    in the reference ``bm`` order: (input dropout at k = 0, conv,
    BatchNorm, activation, dropout, with `rewrite` a 1x1 conv and a leaky
    ReLU, with `scale` a LayerScale and with `post_skip` a depthwise 1x1
    conv without bias; the last two only when the layer keeps its width
    and `skip`), and its gate is ``glus[k]`` = (conv, GLU) or None.

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
    conv and its batch sums in one pass, normalized from those sums; the
    modules before and after it (input dropout; activation, dropout,
    rewrite, LayerScale, post-skip conv) run as they are. In eval mode
    such a layer is the plain conv and BatchNorm on the running
    statistics. The key layout is the same for both settings. As in flax,
    only a stride-1 conv with an odd kernel, not transposed, fuses.
    Without `bn_conv_bias`, no BatchNorm'd conv has a bias (BatchNorm
    cancels it). The convs run in `compute_dtype` (bf16 or None for the
    input's), the post-skip conv in its input's type promoted with its
    weights' (flax's ``dtype=None``). In train mode the dropouts draw
    their masks from the `generator` ``forward`` takes, or take the
    `masks` it is given, in order (the input dropout's, then each layer's)."""

    def __init__(self, channels: tp.Sequence[int], kernel: int = 4,
                 dilation_growth: int = 1,
                 dilation_period: tp.Optional[int] = None,
                 stride: int = 1, decode: bool = False,
                 dropout: float = 0.0, leakiness: float = 0.0,
                 groups: int = 1, batch_norm: bool = False,
                 dropout_input: float = 0.0, skip: bool = False,
                 scale: tp.Optional[float] = None, rewrite: bool = False,
                 activation_on_last: bool = True, post_skip: bool = False,
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
                layers.append(Dropout(dropout_input))
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
                    layers.append(Dropout(dropout))
                if rewrite:
                    layers += [Conv1d(chout, chout, 1,
                                      compute_dtype=compute_dtype),
                               nn.LeakyReLU(leakiness)]
            if chin == chout and skip:
                if scale is not None:
                    layers.append(LayerScale(chout, scale))
                if post_skip:
                    layers.append(Conv1d(chout, chout, 1, groups=chout,
                                         bias=False))
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
    def _fused_train(layer: nn.Sequential, x: torch.Tensor,
                     generator: tp.Optional[torch.Generator],
                     masks: tp.Optional[tp.Iterator[torch.Tensor]]
                     ) -> torch.Tensor:
        """(conv, BatchNorm) in train mode through conv_stats on operands
        in the conv's compute dtype (x's when None), the rest of the layer
        (input dropout before; activation, dropout, rewrite, LayerScale
        and post-skip conv after) as it is."""
        pos = next(i for i, m in enumerate(layer)
                   if isinstance(m, nn.Conv1d))
        conv, bn = layer[pos], layer[pos + 1]
        x = run_layers(layer[:pos], x, generator, masks)
        dt = x.dtype if conv.compute_dtype is None else conv.compute_dtype
        y, s, ss = conv_stats(x.to(dt), conv.weight.to(dt), conv.dilation[0])
        mean, var = batch_mean_var(s, ss, y.shape[0] * y.shape[2])
        x = bn.normalize_train(y.float(), mean, var).to(y.dtype)
        return run_layers(layer[pos + 2:], x, generator, masks)

    def forward(self, x: torch.Tensor,
                generator: tp.Optional[torch.Generator] = None,
                masks: tp.Optional[tp.Iterable[torch.Tensor]] = None
                ) -> torch.Tensor:
        """x [B, C, T] -> [B, C', T']. In train mode the dropouts draw
        from `generator`, or take the next of `masks` (bool keep masks of
        their inputs' shapes, in the order the layers draw them)."""
        masks = None if masks is None else iter(masks)
        for layer, glu, fused in zip(self.sequence, self.glus, self.fused):
            old_x = x
            if fused and self.training:
                x = self._fused_train(layer, x, generator, masks)
            else:
                x = run_layers(layer, x, generator, masks)
            # residual when shapes match (stride-1 stacks)
            if self.skip and x.shape == old_x.shape:
                x = x + old_x
            if glu is not None:
                x = glu(x)
        return x
