"""The work of one step or request, as the plain reference does it at the
cell's shapes: ``torch.utils.flop_counter.FlopCounterMode`` over the
reference on the meta device (no memory, no arithmetic). Each loop
(``benchmark/loops/<loop>.py``) says what one of its units runs; the
count is the algorithm's at these shapes, whatever implements it."""

from __future__ import annotations

import typing as tp

import torch
from torch.utils.flop_counter import FlopCounterMode


def meta_inputs(ref: tp.Any, m: dict, rows: int) -> tuple:
    """(batch, norm, params, stats) of `rows` windows on the meta device,
    the leaves requiring a gradient, for reference `ref` and the
    configuration's model section `m`."""
    meta = torch.device("meta")
    c, f, t, r = (m["sensors"], m["features"], m["window_samples"],
                  m["recordings"])
    batch = dict(meg=torch.zeros(rows, c, t, device=meta),
                 features=torch.zeros(rows, f, t, device=meta),
                 subject_index=torch.zeros(rows, dtype=torch.long,
                                           device=meta),
                 recording_index=torch.zeros(rows, dtype=torch.long,
                                             device=meta))
    norm = dict(meg_center=torch.zeros(r, c, device=meta),
                meg_scale=torch.ones(r, c, device=meta),
                feat_center=torch.zeros(f, device=meta),
                feat_scale=torch.ones(f, device=meta),
                rec_positions=torch.zeros(r, c, 2, device=meta))
    shapes = ref.param_shapes(m)
    params = {k: torch.zeros(s, device=meta, requires_grad=True)
              for k, s in shapes.items()}
    stats = {}
    for name in ref.bn_names(m):
        width = shapes[f"{name}.weight"]
        stats[f"{name}.running_mean"] = torch.zeros(width, device=meta)
        stats[f"{name}.running_var"] = torch.ones(width, device=meta)
    return batch, norm, params, stats


def count(work: tp.Callable[[], tp.Any]) -> int:
    """The FLOPs `work` runs."""
    with FlopCounterMode(display=False) as counter:
        work()
    return int(counter.get_total_flops())
