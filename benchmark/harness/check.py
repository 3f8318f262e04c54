"""The numbers that decide ``correct``: what the timed path produced
against the plain reference (``benchmark/reference``), each held to the
cell's limit (``benchmark/limits/<workload>.json``).

Training (the first three steps of the object the window then drives):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient, the program's as Adam received it (its first moment after one
  step over 1 - beta1), over the larger of the reference's norm of that
  leaf and of the median leaf;
- ``change_gap``: the same of the norms of each leaf's change over the
  three steps, over the leaves whose reference gradient is at least
  GRAD_FLOOR of the median leaf's (below it a leaf moves under Adam by
  round-off alone).

Retrieval (sampled requests of the window): ``estimate_gap``, the worst
row's ``|e - e_ref| / |e_ref|``, and ``probs_gap``, the worst row's total
variation distance between the probabilities over the bank."""

from __future__ import annotations

import math
import statistics
import typing as tp

import torch

#: leaves whose reference gradient is below this share of the median
#: leaf's are left out of the change
GRAD_FLOOR = 1e-3


def _gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor, 1e-30)


def train_numbers(prog: dict, ref: dict) -> tp.Dict[str, float]:
    """`prog` and `ref`: {"loss": [per step], "grad": {leaf: norm},
    "change": {leaf: norm}} (``reference.model.train_steps``'s layout)."""
    if len(prog["loss"]) != len(ref["loss"]):
        return {"loss_gap": math.inf}
    loss = max(_gap(p, r, 0.) for p, r in zip(prog["loss"], ref["loss"]))
    grads = ref["grad"]
    med = statistics.median(grads.values())
    grad = max(_gap(prog["grad"][k], grads[k], med) for k in grads)
    moved = [k for k in grads if grads[k] >= GRAD_FLOOR * med]
    med_c = statistics.median(ref["change"][k] for k in moved)
    change = max(_gap(prog["change"][k], ref["change"][k], med_c)
                 for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def row_gaps(estimate: torch.Tensor, probs: torch.Tensor,
             ref_estimate: torch.Tensor, ref_probs: torch.Tensor
             ) -> tp.Dict[str, float]:
    """One request's worst rows."""
    e = estimate.float().reshape(estimate.shape[0], -1)
    r = ref_estimate.float().reshape(ref_estimate.shape[0], -1)
    est = ((e - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)).max()
    tv = 0.5 * (probs.float() - ref_probs.float()).abs().sum(dim=1).max()
    return {"estimate_gap": float(est), "probs_gap": float(tv)}


def worst(readings: tp.Iterable[tp.Dict[str, float]]) -> tp.Dict[str, float]:
    out: tp.Dict[str, float] = {}
    for reading in readings:
        for name, value in reading.items():
            value = math.inf if not math.isfinite(value) else value
            out[name] = max(out.get(name, -math.inf), value)
    return out


def verdict(numbers: tp.Dict[str, float], limits: tp.Dict[str, float]
            ) -> tp.Tuple[bool, tp.Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit, and every limit read."""
    checks = {name: {"value": numbers.get(name, math.inf), "limit": limit}
              for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
