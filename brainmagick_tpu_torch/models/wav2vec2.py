"""The wav2vec 2.0 encoder in torch, built to HF's ``Wav2Vec2Model``.

The counterpart of ``brainmagick_tpu/models/wav2vec2.py`` (a flax port of
the same architecture), written in plain torch ops: the conv feature
encoder (seven strided convs, a LayerNorm per layer or a GroupNorm on the
first, exact GELU), the feature projection (a LayerNorm, whose output is
HF's ``extract_features``, then a Linear), the weight-normed grouped
positional conv, and the transformer layers, pre-LN with a final
LayerNorm (``do_stable_layer_norm``) or post-LN with the LayerNorm before
the layers. Attention is a matmul, a softmax and a matmul on fp32
(``scaled_dot_product_attention``'s fused paths change fp32 numerics),
over blocks of query rows so that a long sound event's scores stay under
``ATTENTION_BYTES``.

The parameter names are HF's (the positional conv's weight-norm pair as
``weight_g``/``weight_v``), so an HF or ``bm`` state dict loads by name
(``convert.load_wav2vec2_state_dict``), as does a flax tree of the JAX
package (``convert.load_wav2vec2_flax``).

``Wav2Vec2Model(cfg, generator)`` draws HF's initialization from
`generator` bit for bit: the draws HF's modules make as they are built,
then HF's second pass (``_init_weights``, children first). The features
seed it as the JAX package seeds HF's (``seed_of``), so a random=True
track is the same network's in both packages.
"""

from __future__ import annotations

import hashlib
import math
import typing as tp
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

#: the scores of one block of query rows take at most this many bytes
ATTENTION_BYTES = 1 << 30


@dataclass
class Wav2Vec2Config:
    """The fields of HF's ``Wav2Vec2Config`` the encoder reads. The
    defaults are the xlsr-53 architecture the JAX package builds offline
    (``brainmagick_tpu/features/audio.py:362-365``): HF's defaults with
    six overrides, so ``conv_bias=False`` (the real xlsr-53 checkpoint has
    conv biases) and ``mask_time_prob=0.05`` (HF then draws a
    ``masked_spec_embed``, which the features never use)."""
    conv_dim: tp.Tuple[int, ...] = (512,) * 7
    conv_kernel: tp.Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tp.Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = True
    feat_extract_norm: str = "layer"
    initializer_range: float = 0.02
    mask_time_prob: float = 0.05

    @classmethod
    def xlsr53(cls) -> "Wav2Vec2Config":
        """``Wav2Vec2Config(hidden_size=1024, num_hidden_layers=24,
        num_attention_heads=16, intermediate_size=4096,
        do_stable_layer_norm=True, feat_extract_norm="layer")``."""
        return cls()

    @classmethod
    def tiny(cls) -> "Wav2Vec2Config":
        """The flax port's small test config (conv biases on, as flax's
        default has them)."""
        return cls(conv_dim=(16, 16), conv_kernel=(10, 3),
                   conv_stride=(5, 2), conv_bias=True, hidden_size=32,
                   num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=64, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)


def state_digest(state: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, str]:
    """{name: SHA-256 of the tensor's contiguous fp32 bytes}, under the
    port's names (torch's ``parametrizations.weight.original0/1`` read as
    ``weight_g``/``weight_v``), in name order."""
    out = {}
    for key, value in state.items():
        key = key.replace("parametrizations.weight.original0", "weight_g")
        key = key.replace("parametrizations.weight.original1", "weight_v")
        data = value.detach().cpu().float().contiguous().numpy().tobytes()
        out[key] = hashlib.sha256(data).hexdigest()
    return dict(sorted(out.items()))


def seed_of(model_name: str) -> int:
    """The JAX package's seed for a random=True model: the name's first
    four bytes, big-endian (``int.from_bytes(b"face", "big")``)."""
    return int.from_bytes(model_name.encode()[:4], "big")


class _ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, index: int) -> None:
        super().__init__()
        out = cfg.conv_dim[index]
        self.conv = nn.Conv1d(cfg.conv_dim[index - 1] if index else 1, out,
                              cfg.conv_kernel[index],
                              stride=cfg.conv_stride[index],
                              bias=cfg.conv_bias)
        self.layer_norm: tp.Optional[nn.Module] = None
        if cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(out)
        elif cfg.feat_extract_norm != "group":
            raise ValueError(f"feat_extract_norm={cfg.feat_extract_norm!r}")
        elif index == 0:
            self.layer_norm = nn.GroupNorm(out, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if isinstance(self.layer_norm, nn.LayerNorm):
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    """[B, T] waveform -> [B, conv_dim[-1], T'] latent."""

    def __init__(self, cfg: Wav2Vec2Config) -> None:
        super().__init__()
        self.conv_layers = nn.ModuleList(
            _ConvLayer(cfg, k) for k in range(len(cfg.conv_dim)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config) -> None:
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)


class _WeightNormConv(nn.Module):
    """A grouped Conv1d's parameters under weight normalization with
    ``dim=2`` (HF's): one gain per kernel position, the norm over each
    position's (out, in) slice."""

    def __init__(self, channels: int, kernel: int, groups: int) -> None:
        super().__init__()
        self.weight_g = nn.Parameter(torch.empty(1, 1, kernel))
        self.weight_v = nn.Parameter(
            torch.empty(channels, channels // groups, kernel))
        self.bias = nn.Parameter(torch.empty(channels))
        self.groups = groups

    @property
    def weight(self) -> torch.Tensor:
        return torch._weight_norm(self.weight_v, self.weight_g, 2)


class PositionalConvEmbedding(nn.Module):
    """[B, T, H] -> [B, T, H]: the weight-normed grouped conv (padding
    k // 2, the last sample dropped for an even k), then GELU."""

    def __init__(self, cfg: Wav2Vec2Config) -> None:
        super().__init__()
        self.kernel = cfg.num_conv_pos_embeddings
        self.conv = _WeightNormConv(cfg.hidden_size, self.kernel,
                                    cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.conv.weight, self.conv.bias,
                     padding=self.kernel // 2, groups=self.conv.groups)
        if self.kernel % 2 == 0:
            y = y[..., :-1]
        return F.gelu(y).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // self.num_heads
        # HF's registration order, which its initialization follows
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.q_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape

        def heads(y: torch.Tensor) -> torch.Tensor:
            return y.view(b, t, self.num_heads, self.head_dim).transpose(1, 2)

        q = heads(self.q_proj(x) * self.head_dim ** -0.5)
        k = heads(self.k_proj(x)).transpose(2, 3)
        v = heads(self.v_proj(x))
        rows = max(1, ATTENTION_BYTES // (4 * b * self.num_heads * t))
        out = torch.cat([torch.softmax(q[:, :, i:i + rows] @ k, dim=-1) @ v
                         for i in range(0, t, rows)], dim=2)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, h))


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config) -> None:
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size,
                                      cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """A transformer layer, pre-LN when `stable`, else post-LN."""

    def __init__(self, cfg: Wav2Vec2Config) -> None:
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.attention = Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stable:
            x = x + self.attention(self.layer_norm(x))
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config) -> None:
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


class Wav2Vec2Model(nn.Module):
    """HF's ``Wav2Vec2Model`` without masking, dropout or an adapter
    (inference), its parameters drawn as HF draws them from `generator`
    (a CPU ``torch.Generator``; seed 0 when None). The modules are built
    on the meta device, so building draws nothing from torch's global
    generator, then allocated on the CPU and initialized."""

    def __init__(self, cfg: Wav2Vec2Config,
                 generator: tp.Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            self.feature_extractor = FeatureEncoder(cfg)
            self.feature_projection = FeatureProjection(cfg)
            if cfg.mask_time_prob > 0:
                self.masked_spec_embed = nn.Parameter(
                    torch.empty(cfg.hidden_size))
            self.encoder = Encoder(cfg)
        self.to_empty(device="cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        hf_init_(self, generator)

    def frontend(self, wav: torch.Tensor
                 ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """[B, T] waveform -> (the encoder's input [B, T', H], HF's
        ``extract_features`` [B, T', conv_dim[-1]])."""
        x = self.feature_extractor(wav).transpose(1, 2)
        extract = self.feature_projection.layer_norm(x)
        x = self.feature_projection.projection(extract)
        x = x + self.encoder.pos_conv_embed(x)
        if not self.cfg.do_stable_layer_norm:
            x = self.encoder.layer_norm(x)
        return x, extract

    def forward(self, wav: torch.Tensor,
                layers: tp.Optional[tp.Sequence[int]] = None
                ) -> tp.Tuple[torch.Tensor, torch.Tensor,
                              tp.Tuple[torch.Tensor, ...]]:
        """(last hidden state, extract_features, hidden states) with HF's
        indexing: hidden state k < L is layer k's input, L the output
        after the final LayerNorm (pre-LN) or the last layer's (post-LN).
        Only the indices in `layers` (all L + 1 when None) are kept, in
        that order."""
        n = self.cfg.num_hidden_layers
        wanted = list(range(n + 1)) if layers is None else list(layers)
        if not all(0 <= k <= n for k in wanted):
            raise ValueError(f"hidden-state indices {wanted} outside "
                             f"[0, {n}]")
        x, extract = self.frontend(wav)
        kept = {}
        for k, layer in enumerate(self.encoder.layers):
            if k in wanted:
                kept[k] = x
            x = layer(x)
        if self.cfg.do_stable_layer_norm:
            x = self.encoder.layer_norm(x)
        kept[n] = x
        return x, extract, tuple(kept[k] for k in wanted)


# ---------------------------------------------------------------------------
# HF's initialization, draw for draw
# ---------------------------------------------------------------------------

def _built(weight: torch.Tensor, bias: tp.Optional[torch.Tensor],
           g: torch.Generator) -> None:
    """``nn.Linear``'s and ``nn.Conv1d``'s ``reset_parameters``."""
    nn.init.kaiming_uniform_(weight, a=math.sqrt(5), generator=g)
    if bias is not None:
        fan_in = weight[0].numel()
        bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
        nn.init.uniform_(bias, -bound, bound, generator=g)


def _norm(module: tp.Optional[nn.Module]) -> None:
    if module is not None:
        nn.init.ones_(module.weight)
        nn.init.zeros_(module.bias)


def _conv_second(weight: torch.Tensor, bias: tp.Optional[torch.Tensor],
                 groups: int, g: torch.Generator) -> None:
    """HF's ``_init_weights`` of an ``nn.Conv1d``."""
    nn.init.kaiming_normal_(weight, generator=g)
    if bias is not None:
        k = math.sqrt(groups / (weight.shape[1] * groups * weight.shape[2]))
        nn.init.uniform_(bias, -k, k, generator=g)


def _linear_second(linear: nn.Linear, std: float,
                   g: torch.Generator) -> None:
    """HF's ``_init_weights`` of an ``nn.Linear``."""
    nn.init.normal_(linear.weight, 0.0, std, generator=g)
    nn.init.zeros_(linear.bias)


@torch.no_grad()
def hf_init_(model: Wav2Vec2Model, g: torch.Generator) -> None:
    """Draw `model`'s parameters from `g` as ``transformers
    .Wav2Vec2Model(config)`` draws them from torch's global generator.

    First the draws of HF's constructors, in the order its modules are
    built: each conv and Linear's ``reset_parameters``, then
    ``masked_spec_embed``'s ``uniform_`` (drawn when ``mask_time_prob >
    0``), with the positional conv's weight drawn whole and then split
    into HF's weight-norm pair. Then HF's ``post_init``: ``_init_weights``
    on every module, children first in registration order. Its
    ``kaiming_normal_`` and ``normal_`` on the weight-normed conv land on a
    computed weight: they consume draws and change nothing, so that conv
    keeps its first weight, and its bias ends at zero."""
    cfg = model.cfg
    convs = model.feature_extractor.conv_layers
    projection = model.feature_projection.projection
    pos = model.encoder.pos_conv_embed.conv
    layers = model.encoder.layers

    def linears(layer: EncoderLayer) -> tp.List[nn.Linear]:
        a, f = layer.attention, layer.feed_forward
        return [a.k_proj, a.v_proj, a.q_proj, a.out_proj,
                f.intermediate_dense, f.output_dense]

    # 1. the constructors
    for layer in convs:
        _built(layer.conv.weight, layer.conv.bias, g)
    _built(projection.weight, projection.bias, g)
    if cfg.mask_time_prob > 0:
        nn.init.uniform_(model.masked_spec_embed, generator=g)
    whole = torch.empty(pos.weight_v.shape)
    _built(whole, pos.bias, g)
    pos.weight_g.copy_(torch.norm_except_dim(whole, 2, 2))
    pos.weight_v.copy_(whole)
    for layer in layers:
        for linear in linears(layer):
            _built(linear.weight, linear.bias, g)

    # 2. post_init
    for layer in convs:
        _conv_second(layer.conv.weight, layer.conv.bias, 1, g)
        _norm(layer.layer_norm)
    _norm(model.feature_projection.layer_norm)
    _linear_second(projection, cfg.initializer_range, g)
    k = math.sqrt(1 / projection.in_features)
    nn.init.uniform_(projection.weight, -k, k, generator=g)
    nn.init.uniform_(projection.bias, -k, k, generator=g)
    # the weight-normed conv: its own init, then the embedding's
    _conv_second(whole, pos.bias, pos.groups, g)
    nn.init.normal_(whole, 0.0, 2 * math.sqrt(
        1 / (whole.shape[2] * whole.shape[0])), generator=g)
    nn.init.zeros_(pos.bias)
    _norm(model.encoder.layer_norm)
    for layer in layers:
        for linear in linears(layer)[:4]:
            _linear_second(linear, cfg.initializer_range, g)
        _norm(layer.layer_norm)
        for linear in linears(layer)[4:]:
            _linear_second(linear, cfg.initializer_range, g)
        _norm(layer.final_layer_norm)
