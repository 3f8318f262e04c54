"""One run of one cell: the loop that the cell's traffic mix names
(``benchmark/loops/<loop>.py``) makes the set-up, the measured window and
the comparison with the reference; this module turns what it returns
into the result, and holds what every loop shares. With ``trace`` the
loop runs its window under the profiler, and the cell's per-layer readers
take their numbers from the ``Record`` it returns."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time
import typing as tp

import torch
from torch.profiler import record_function

from . import check, spec
from . import trace as tracing

#: modules no run may hold, compared by top-level name
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "brainmagick_tpu"})

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules() -> tp.List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & FORBIDDEN)


def check_modules() -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"the run holds forbidden modules: {found}")


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads: the cell, the traced window and the
    harness's own spans and counters over it."""

    cell: spec.Cell
    trace: tracing.Trace
    units: int                      # steps or requests in the window
    rows: int                       # windows per step or request
    host_s: tp.Dict[str, float]     # host seconds inside each span
    cuda_ms: tp.Dict[str, tp.List[float]]   # CUDA-event ms a request
    launches: tp.Dict[str, int]     # the program's kernel launches
    #: the plain reference's FLOPs of the window's units, summed by the
    #: loop from each unit's shapes; None where every unit does the same
    #: work, ``unit_flops`` of the loop
    flops: tp.Optional[int] = None
    #: each unit's shapes, in order, where units differ
    shapes: tp.Optional[tp.List[dict]] = None

    @property
    def model(self) -> dict:
        return self.cell.config["model"]


@contextlib.contextmanager
def span(name: str, on: bool) -> tp.Iterator[None]:
    if on:
        with record_function(name):
            yield
    else:
        yield


@contextlib.contextmanager
def fp32_flags() -> tp.Iterator[None]:
    """TF32 off for the reference; the flags restored after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    previous = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = previous


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


class Phases:
    """Host seconds of each part of set-up, from the process's start."""

    def __init__(self, t_start: float) -> None:
        self.at, self.seconds = t_start, {}

    def mark(self, name: str) -> float:
        now = time.perf_counter()
        self.seconds[name] = now - self.at
        self.at = now
        return now


def _number(value: float) -> float:
    """JSON has no infinity: the largest double stands for it."""
    return value if math.isfinite(value) else sys.float_info.max


def run(root: tp.Any, workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        bench_dir: tp.Any = None) -> dict:
    """One run of `workload` on `device`; the result line's object
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
    `trace` ``breakdown``, and last ``checks``: each number compared with
    its limit)."""
    cell = spec.load_cell(root, workload, bench_dir)
    if device.type == "cuda":
        torch.empty(0, device=device)       # the device's allocator set up
        torch.cuda.reset_peak_memory_stats(device)
    out = cell.loop.window(cell, seed, seconds, trace, device, t_start)
    correct, checks = check.verdict(out["numbers"], cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        record = out["record"]
        metrics = {}
        for metric in cell.per_layer:
            value = spec.reader(metric["name"], bench_dir).read(record)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": units[metric["name"]]}
    else:
        metrics = {name: {"value": value, "unit": units[name]}
                   for name, value in out["end_to_end"].items()
                   if name in units}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    # host-side readings of this run, with or without the profiler
    result["diagnostics"] = out["diagnostics"]
    result["checks"] = {name: {"value": _number(c["value"]),
                               "limit": c["limit"]}
                        for name, c in checks.items()}
    return result
