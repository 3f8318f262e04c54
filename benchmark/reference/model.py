"""Plain PyTorch reference of the benchmarked paths, in float32.

The paper's brain encoder (Défossez et al. 2023, arXiv:2208.12266, the
``clip_conv`` recipe of facebookresearch/brainmagick) with the DeepMel
feature model of its Table 2, the robust-scaler normalization with its
clamp, the CLIP loss, the retrieval probabilities and Adam, written from
the published description with no kernel, cache or fusion. Parameters
live in one flat dict keyed by the published module layout
(``merger.heads``, ``encoders.meg.sequence.{k}.0.weight``, ...), so the
benchmark can hand the same seeded tensors to the program and to this
file. Every function takes the architecture as a plain dict (the
``model`` section of a configuration file).

``rnd`` is the rounding applied to the operands of every contraction
(convolutions, einsums, matrix products): the identity for the
reference itself; ``round_tf32`` or ``round_fp8`` for the controls that
compute the same thing one precision lower.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

Params = tp.Dict[str, torch.Tensor]
Round = tp.Callable[[torch.Tensor], torch.Tensor]

#: a sensor without a position (a bad or missing channel)
INVALID_POSITION = -0.1
#: BatchNorm's epsilon and the weight of the old running statistics
BN_EPS, BN_MOMENTUM = 1e-5, 0.99


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """`rounded` forward, the identity backward (a rounded operand's
    gradient is the operand's)."""
    x = x.float()
    return x + (rounded - x).detach()


@torch.no_grad()
def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


@torch.no_grad()
def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / 448.
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 `x` rounded to TF32's 10 mantissa bits (to nearest, ties
    away), as the tensor cores read an fp32 operand with TF32 on."""
    return _through(x, _tf32(x))


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` through float8 e4m3 with one scale for the tensor (its largest
    magnitude at e4m3's largest value, 448), as an fp8 GEMM reads it."""
    return _through(x, _fp8(x))


ROUNDINGS: tp.Dict[str, Round] = {"float32": identity, "tf32": round_tf32,
                                  "fp8": round_fp8}


# -- shapes -----------------------------------------------------------------

def _sequence_shapes(prefix: str, channels: tp.Sequence[int], kernel: int,
                     glu: int, glu_context: int, batch_norm: bool,
                     conv_bias: bool, activation_on_last: bool
                     ) -> tp.Dict[str, tuple]:
    shapes = {}
    for k, (chin, chout) in enumerate(zip(channels[:-1], channels[1:])):
        last = k == len(channels) - 2
        has_bn = batch_norm and (activation_on_last or not last)
        shapes[f"{prefix}sequence.{k}.0.weight"] = (chout, chin, kernel)
        if conv_bias or not has_bn:
            shapes[f"{prefix}sequence.{k}.0.bias"] = (chout,)
        if has_bn:
            shapes[f"{prefix}sequence.{k}.1.weight"] = (chout,)
            shapes[f"{prefix}sequence.{k}.1.bias"] = (chout,)
        if glu and (k + 1) % glu == 0:
            width = 1 + 2 * glu_context
            shapes[f"{prefix}glus.{k}.0.weight"] = (2 * chout, chout, width)
            shapes[f"{prefix}glus.{k}.0.bias"] = (2 * chout,)
    return shapes


def encoder_channels(m: dict) -> tp.List[int]:
    return [m["initial_linear"]] + [m["hidden"]] * m["depth"]


def deepmel_channels(m: dict) -> tp.List[int]:
    d = m["deep_mel"]
    return ([m["features"]] + [d["hidden"]] * (d["layers"] - 1)
            + [d["out"]])


def param_shapes(m: dict) -> tp.Dict[str, tuple]:
    """{name: shape} of every trained leaf, the feature model's under
    ``fm.``."""
    out_dim = m["deep_mel"]["out"] if m.get("deep_mel") else m["features"]
    o, h = m["merger_channels"], m["hidden"]
    shapes = {"merger.heads": (o, m["merger_pos_dim"]),
              "initial_linear.0.weight": (m["initial_linear"], o, 1),
              "initial_linear.0.bias": (m["initial_linear"],),
              "subject_layers.weights": (m["subjects"], m["initial_linear"],
                                         m["initial_linear"])}
    shapes.update(_sequence_shapes(
        "encoders.meg.", encoder_channels(m), m["kernel"], m["glu"],
        m["glu_context"], True, m["bn_conv_bias"], True))
    shapes.update({"final.0.weight": (2 * h, h, 1), "final.0.bias": (2 * h,),
                   "final.2.weight": (2 * h, out_dim, 1),
                   "final.2.bias": (out_dim,)})
    if m.get("deep_mel"):
        shapes.update(_sequence_shapes(
            "fm.", deepmel_channels(m), 3, 2, 1, True, m["bn_conv_bias"],
            False))
    return shapes


def bn_names(m: dict) -> tp.List[str]:
    """The BatchNorm layers (their ``.running_mean``/``.running_var``)."""
    return [name[:-len(".weight")] for name, shape in param_shapes(m).items()
            if name.endswith(".1.weight") and len(shape) == 1]


# -- the model ----------------------------------------------------------------

def fourier_emb(positions: torch.Tensor, dimension: int,
                margin: float = 0.2) -> torch.Tensor:
    """The paper's 2D Fourier embedding of sensor positions [..., 2] ->
    [..., dimension]: cos and sin of 2 pi (k_x x + k_y y) / (1 + 2 margin)
    over a k x k frequency grid, positions shifted by the margin."""
    n = int(round(math.sqrt(dimension // 2)))
    freqs = torch.arange(n, dtype=positions.dtype, device=positions.device)
    pos = positions + margin
    phase = 2 * math.pi / (1 + 2 * margin) * (
        pos[..., 0, None, None] * freqs[:, None]
        + pos[..., 1, None, None] * freqs[None, :])
    phase = phase.reshape(*positions.shape[:-1], n * n)
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.relu(x)
    return F.gelu(x, approximate="tanh" if kind == "tanh" else "none")


def batch_norm(y: torch.Tensor, p: Params, name: str, stats: Params,
               train: bool) -> torch.Tensor:
    """BatchNorm over (batch, time): in train mode the batch's mean and
    biased variance, folded into the running statistics of `stats`; in
    eval mode the running ones."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        mean = y.mean(dim=(0, 2))
        var = ((y * y).mean(dim=(0, 2)) - mean * mean).clamp(min=0)
        with torch.no_grad():
            for key, value in (("running_mean", mean), ("running_var", var)):
                stats[f"{name}.{key}"] = (BN_MOMENTUM * stats[f"{name}.{key}"]
                                          + (1 - BN_MOMENTUM) * value)
    else:
        mean, var = stats[f"{name}.running_mean"], stats[f"{name}.running_var"]
    return ((y - mean[:, None]) * torch.rsqrt(var + BN_EPS)[:, None]
            * w[:, None] + b[:, None])


def conv(x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor],
         rnd: Round, dilation: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv1d(rnd(x), rnd(w), b, padding=padding, dilation=dilation)


def conv_sequence(x: torch.Tensor, p: Params, prefix: str,
                  channels: tp.Sequence[int], stats: Params, train: bool,
                  rnd: Round, activation: str, kernel: int, glu: int,
                  glu_context: int, dilation_period: int,
                  activation_on_last: bool) -> torch.Tensor:
    """The dilated conv stack: per layer a conv (dilation doubling, reset
    every `dilation_period` layers), BatchNorm and the activation, the
    residual when the width is kept, and every `glu` layers a GLU gate."""
    dilation = 1
    for k in range(len(channels) - 1):
        last = k == len(channels) - 2
        if dilation_period and k % dilation_period == 0:
            dilation = 1
        name = f"{prefix}sequence.{k}"
        y = conv(x, p[f"{name}.0.weight"], p.get(f"{name}.0.bias"), rnd,
                 dilation, kernel // 2 * dilation)
        dilation *= 2
        if activation_on_last or not last:
            y = gelu(batch_norm(y, p, f"{name}.1", stats, train), activation)
        if y.shape == x.shape:
            y = y + x
        if glu and (k + 1) % glu == 0:
            g = f"{prefix}glus.{k}.0"
            y = F.glu(conv(y, p[f"{g}.weight"], p[f"{g}.bias"], rnd, 1,
                           glu_context), dim=1)
        x = y
    return x


def merger_weights(p: Params, m: dict, rec_positions: torch.Tensor,
                   center: tp.Optional[torch.Tensor], rnd: Round
                   ) -> torch.Tensor:
    """Spatial attention of each recording [R, O, C]: the heads' scores
    over the Fourier embedding of its sensors, a softmax over sensors
    that leaves out those with no position and, in training, those within
    the merger's dropout radius of `center` (a recording whose every
    sensor is left out keeps its raw scores)."""
    emb = fourier_emb(rec_positions, m["merger_pos_dim"])
    scores = torch.einsum("rcd,od->roc", rnd(emb), rnd(p["merger.heads"]))
    masked = (rec_positions == INVALID_POSITION).all(dim=-1)
    if center is not None:
        dist = torch.linalg.vector_norm(rec_positions - center, dim=-1)
        masked = masked | (dist <= m["merger_dropout"])
    keep_all = masked.all(dim=-1, keepdim=True)
    offset = torch.zeros(masked.shape, device=scores.device).masked_fill(
        masked & ~keep_all, -math.inf)
    return torch.softmax(scores + offset[:, None, :], dim=2)


def normalize(meg: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
              rec: torch.Tensor, limit: float, clip: bool) -> torch.Tensor:
    """Each recording's robust scaling of its sensors, clamped at
    +-`limit` when `clip`."""
    x = (meg.float() - center[rec][:, :, None]) / scale[rec][:, :, None]
    return x.clamp(-limit, limit) if clip else x


def encode(p: Params, stats: Params, m: dict, batch: tp.Mapping,
           norm: tp.Mapping, train: bool, center: tp.Optional[torch.Tensor],
           rnd: Round = identity) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(estimate [B, F, T'], targets [B, F, T']) of a decoding batch: the
    MEG normalized and shifted by the offset, merged, remixed per
    subject, encoded and projected; the features normalized, trimmed to
    the same samples and, with DeepMel, encoded by it."""
    rec, subj = batch["recording_index"], batch["subject_index"]
    off = m["offset_samples"]
    meg = normalize(batch["meg"], norm["meg_center"], norm["meg_scale"], rec,
                    m["max_scale"], m["clip"])[..., off:]
    feats = ((batch["features"].float() - norm["feat_center"][None, :, None])
             / norm["feat_scale"][None, :, None])[..., :meg.shape[-1]]
    weights = merger_weights(p, m, norm["rec_positions"],
                             center if train else None, rnd)
    x = torch.einsum("bct,boc->bot", rnd(meg), rnd(weights[rec]))
    x = conv(x, p["initial_linear.0.weight"], p["initial_linear.0.bias"], rnd)
    x = torch.einsum("bct,bcd->bdt", rnd(x),
                     rnd(p["subject_layers.weights"][subj]))
    x = conv_sequence(x, p, "encoders.meg.", encoder_channels(m), stats,
                      train, rnd, m["activation"], m["kernel"], m["glu"],
                      m["glu_context"], m["dilation_period"], True)
    x = gelu(conv(x, p["final.0.weight"], p["final.0.bias"], rnd),
             m["activation"])
    x = F.conv_transpose1d(rnd(x), rnd(p["final.2.weight"]),
                           p["final.2.bias"])
    if m.get("deep_mel"):
        feats = conv_sequence(feats, p, "fm.", deepmel_channels(m), stats,
                              train, rnd, "relu", 3, 2, 1, 5, False)
    return x, feats


def inv_norms(c2: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(c2, dim=1)
    return 1 / (1e-8 + norms)


def clip_scores(estimate: torch.Tensor, candidates: torch.Tensor,
                rnd: Round = identity) -> torch.Tensor:
    """[B, F, T] x [N, F, T] -> [B, N]: each estimate's inner product
    with each candidate over the candidate's norm."""
    e2 = estimate.reshape(estimate.shape[0], -1).float()
    c2 = candidates.reshape(candidates.shape[0], -1).float()
    return (rnd(e2) @ rnd(c2).T) * inv_norms(c2)[None, :]


def clip_loss(estimate: torch.Tensor, targets: torch.Tensor,
              rnd: Round = identity) -> torch.Tensor:
    """The CLIP loss: the cross-entropy of each estimate against its own
    target among the batch's targets."""
    logp = torch.log_softmax(clip_scores(estimate, targets, rnd), dim=1)
    return -torch.diagonal(logp).mean()


def probabilities(estimate: torch.Tensor, bank: torch.Tensor,
                  rnd: Round = identity) -> torch.Tensor:
    return torch.softmax(clip_scores(estimate, bank, rnd), dim=1)


class Adam:
    """``torch.optim.Adam``'s update (no weight decay), over a dict."""

    def __init__(self, params: Params, lr: float, betas: tp.Sequence[float],
                 eps: float) -> None:
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(weights: Params, stats: Params, m: dict,
                batches: tp.Sequence[tp.Mapping], norm: tp.Mapping,
                centers: tp.Sequence[torch.Tensor], rnd: Round = identity
                ) -> dict:
    """`len(batches)` Adam steps of the CLIP loss from `weights` (not
    modified): {"loss": [each step's loss], "grad": {leaf: the first
    step's gradient norm}, "change": {leaf: the norm of its change after
    the last step}}. `centers` are the merger dropout's disk centres, one
    a step."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    stats = dict(stats)
    adam = Adam(params, m["lr"], m["betas"], m["eps"])
    out: dict = {"loss": []}
    for step, (batch, center) in enumerate(zip(batches, centers)):
        estimate, targets = encode(params, stats, m, batch, norm, True,
                                   center, rnd)
        loss = clip_loss(estimate, targets, rnd)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad"] = {k: float(g.norm()) for k, g
                           in zip(params, grads)}
        adam.step(params, dict(zip(params, grads)))
        del estimate, targets, loss, grads
    out["change"] = {k: float((params[k].detach() - weights[k]).norm())
                     for k in params}
    return out
