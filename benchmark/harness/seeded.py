"""Everything a run feeds both sides, made on the device from ``--seed``:
weights and BatchNorm statistics, the per-recording normalization tables
and sensor positions, the pool of batches and the candidate bank. Each is
drawn by a ``torch.Generator`` on the run's device in a few large calls,
so that the same seed gives the same tensors, and every seed gives the
same sizes and the same spread of rows over recordings. The leaves'
names and shapes, and the mark of a sensor without a position, are the
configuration's reference's (``ref``)."""

from __future__ import annotations

import typing as tp

import torch

Tensors = tp.Dict[str, torch.Tensor]

#: sub-streams of a run's seed
WEIGHTS, TABLES, BATCHES, BANK, DROPOUT, SAMPLE = range(6)
#: share of a window's MEG samples that are artifacts past the clamp
SPIKE_SHARE = 1e-3
#: MEG sensors without a position a recording, per hundred sensors
BAD_PER_HUNDRED = 1


def stream(seed: int, which: int) -> int:
    """A 63-bit seed for sub-stream `which` of the run's `seed` (any whole
    number)."""
    return (int(seed) * 1_000_003 + which * 7919 + 1) % (2 ** 63 - 1)


def generator(seed: int, which: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, which))


def init_scale(name: str, shape: tp.Sequence[int]) -> tp.Tuple[float, float]:
    """(mean, standard deviation) of a leaf: LeCun-scaled convs (a
    transposed conv's fan-in is its first axis), merger heads and subject
    matrices, BatchNorm near identity, small biases."""
    if name.endswith(".1.weight") and len(shape) == 1:
        return 1.0, 0.1
    if name.endswith(".1.bias") and len(shape) == 1:
        return 0.0, 0.1
    if len(shape) == 1:
        return 0.0, 0.02
    if name == "final.2.weight":
        return 0.0, (shape[0] * shape[2]) ** -0.5
    if len(shape) == 3 and name.endswith("weight"):
        return 0.0, (shape[1] * shape[2]) ** -0.5
    if name == "subject_layers.weights":
        return 0.0, shape[1] ** -0.5
    return 0.0, shape[-1] ** -0.5


def weights(ref: tp.Any, m: dict, seed: int, device: torch.device
            ) -> tp.Tuple[Tensors, Tensors]:
    """(trained leaves, BatchNorm running statistics) of configuration
    `m`, fp32: one normal draw for all leaves, one for the running means
    and one uniform draw for the running variances (0.5 to 1.5)."""
    shapes = ref.param_shapes(m)
    g = generator(seed, WEIGHTS, device)
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=g, device=device)
    params, at = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        mean, std = init_scale(name, shape)
        params[name] = (flat[at:at + n].view(shape) * std + mean).contiguous()
        at += n
    names = ref.bn_names(m)
    widths = [shapes[f"{n}.weight"][0] for n in names]
    means = torch.randn(sum(widths), generator=g, device=device) * 0.1
    variances = torch.rand(sum(widths), generator=g, device=device) + 0.5
    stats, at = {}, 0
    for name, width in zip(names, widths):
        stats[f"{name}.running_mean"] = means[at:at + width].clone()
        stats[f"{name}.running_var"] = variances[at:at + width].clone()
        at += width
    return params, stats


def tables(ref: tp.Any, m: dict, seed: int, device: torch.device
           ) -> Tensors:
    """The normalization tables of every recording (``meg_center``,
    ``meg_scale`` [R, C]; ``feat_center``, ``feat_scale`` [F]), the sensor
    positions [R, C, 2] (one helmet layout, each recording's head placed
    a little differently, BAD_PER_HUNDRED sensors per hundred without a
    position) and each recording's subject [R] (one recording a subject,
    cycling when there are more recordings)."""
    g = generator(seed, TABLES, device)
    r, c, f = m["recordings"], m["sensors"], m["features"]
    layout = torch.rand(c, 2, generator=g, device=device) * 0.8 + 0.1
    positions = layout + 0.01 * torch.randn(r, c, 2, generator=g,
                                            device=device)
    n_bad = max(1, c * BAD_PER_HUNDRED // 100)
    bad = torch.rand(r, c, generator=g, device=device).argsort(dim=1)[:, :n_bad]
    positions.scatter_(1, bad[:, :, None].expand(-1, -1, 2),
                       ref.INVALID_POSITION)
    return dict(
        meg_center=0.1 * torch.randn(r, c, generator=g, device=device),
        meg_scale=0.5 + 1.5 * torch.rand(r, c, generator=g, device=device),
        feat_center=0.1 * torch.randn(f, generator=g, device=device),
        feat_scale=0.5 + 1.5 * torch.rand(f, generator=g, device=device),
        rec_positions=positions,
        rec_subjects=torch.arange(r, device=device) % m["subjects"])


def batches(m: dict, norm: Tensors, rows: int, count: int, seed: int,
            device: torch.device, wire: torch.dtype) -> tp.List[Tensors]:
    """`count` batches of `rows` windows, each with the dataset's arrays
    (``meg`` and ``features`` in the `wire` dtype, ``features_mask``,
    int64 ``subject_index`` and ``recording_index``, ``positions``): the
    rows spread evenly over the recordings in a seeded order; MEG of
    roughly three times each sensor's scale around its center, with
    SPIKE_SHARE of its samples artifacts of 25 to 50 times the scale
    (past the clamp); features standard normal."""
    g = generator(seed, BATCHES, device)
    c, f, t = m["sensors"], m["features"], m["window_samples"]
    r = m["recordings"]
    out = []
    for i in range(count):
        rec = (torch.arange(rows, device=device) + i * rows) % r
        rec = rec[torch.randperm(rows, generator=g, device=device)]
        center = norm["meg_center"][rec][:, :, None]
        scale = norm["meg_scale"][rec][:, :, None]
        meg = torch.randn(rows, c, t, generator=g, device=device) * 3
        spikes = torch.rand(rows, c, t, generator=g, device=device)
        size = 25 + 25 * spikes / SPIKE_SHARE
        meg = torch.where(spikes < SPIKE_SHARE,
                          torch.where(meg > 0, size, -size), meg)
        meg = center + scale * meg
        features = torch.randn(rows, f, t, generator=g, device=device)
        out.append(dict(
            meg=meg.to(wire), features=features.to(wire),
            features_mask=torch.ones(rows, 1, t, dtype=torch.bool,
                                     device=device),
            subject_index=norm["rec_subjects"][rec].long(),
            recording_index=rec.long(),
            positions=norm["rec_positions"][rec].contiguous()))
        del meg, spikes, size, features
    return out


def bank(m: dict, count: int, seed: int, device: torch.device,
         dtype: torch.dtype, chunk: int = 256) -> torch.Tensor:
    """`count` standard normal candidates [N, F, T'] in `dtype`, drawn
    `chunk` at a time."""
    g = generator(seed, BANK, device)
    t_out = m["window_samples"] - m["offset_samples"]
    out = torch.empty(count, m["features"], t_out, dtype=dtype, device=device)
    for lo in range(0, count, chunk):
        hi = min(count, lo + chunk)
        out[lo:hi] = torch.randn(hi - lo, m["features"], t_out, generator=g,
                                 device=device).to(dtype)
    return out


def centers(seed: int, count: int) -> tp.List[torch.Tensor]:
    """The merger dropout's first `count` disk centres, as the program's
    generator, seeded ``stream(seed, DROPOUT)`` on the host, draws them:
    one uniform pair a train step."""
    g = torch.Generator().manual_seed(stream(seed, DROPOUT))
    return [torch.rand(2, generator=g) for _ in range(count)]
