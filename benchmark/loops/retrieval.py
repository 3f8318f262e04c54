"""The ``retrieval`` loop: closed loop, one client. Each request is
``Server.forward_batch`` of a resident pool batch and
``Server.probabilities`` against the resident bank of candidates, on the
server that the cell's program entry's ``server`` builds, and ends in a
synchronize; its latency runs from its start to that synchronize. A unit
is one request.

The mix's keys: ``rows`` (windows a request), ``pool_batches`` (distinct
seeded request batches resident on the card in the wire dtype, rotated
each request), ``candidates`` (the bank, in the scores' dtype),
``warm_requests``, ``sample_requests`` (requests held to the reference
besides the window's first, drawn from the seed over all the window's
requests)."""

from __future__ import annotations

import random
import statistics
import time
import types
import typing as tp

import numpy as np
import torch

from benchmark.harness import cell as harness
from benchmark.harness import check, flops, seeded, spec
from benchmark.harness import trace as tracing


class Sample:
    """The window's first request and `count` more drawn uniformly from
    all its later ones (reservoir sampling, the draws from the seed), each
    kept with what the program answered."""

    def __init__(self, seed: int, count: int) -> None:
        self.rng = random.Random(seeded.stream(seed, seeded.SAMPLE))
        self.count = count
        self.first: tp.Optional[tuple] = None
        self.reservoir: tp.List[tuple] = []

    def offer(self, index: int, answer: tuple) -> None:
        if index == 0:
            self.first = (index, *answer)
        elif len(self.reservoir) < self.count:
            self.reservoir.append((index, *answer))
        else:
            slot = self.rng.randrange(index)
            if slot < self.count:
                self.reservoir[slot] = (index, *answer)

    def kept(self) -> tp.List[tuple]:
        return ([self.first] if self.first else []) + sorted(
            self.reservoir, key=lambda kept: kept[0])


def _reference(ref: tp.Any, params: dict, stats: dict, m: dict,
               batch: dict, norm: dict, bank: torch.Tensor,
               rounding: str = "float32") -> tuple:
    rnd = ref.ROUNDINGS[rounding]
    with torch.no_grad(), harness.fp32_flags():
        estimate, _ = ref.encode(params, stats, m, batch, norm, False, None,
                                 rnd)
        return estimate, ref.probabilities(estimate, bank, rnd)


def _inputs(c: spec.Cell, seed: int, device: torch.device) -> tuple:
    m, mix, ref = c.config["model"], c.traffic, c.reference
    params, stats = seeded.weights(ref, m, seed, device)
    norm = seeded.tables(ref, m, seed, device)
    pool = seeded.batches(m, norm, mix["rows"], mix["pool_batches"], seed,
                          device, harness.DTYPES[c.config["wire_dtype"]])
    bank = seeded.bank(m, mix["candidates"], seed, device,
                       harness.DTYPES[c.config["scores_dtype"]])
    return params, stats, norm, pool, bank


def window(c: spec.Cell, seed: int, seconds: float, trace: bool,
           device: torch.device, t_start: float) -> dict:
    m, mix, ref = c.config["model"], c.traffic, c.reference
    rows = mix["rows"]
    phases = harness.Phases(t_start)
    phases.mark("start")
    params, stats, norm, pool, bank = _inputs(c, seed, device)
    harness.sync(device)
    phases.mark("inputs")
    server = c.program.server(c.config, params, stats, norm, device)
    phases.mark("program")
    requests = [types.SimpleNamespace(**b) for b in pool]
    sample = Sample(seed, mix["sample_requests"])
    at = 0
    for _ in range(mix["warm_requests"]):
        estimate = server.forward_batch(requests[at % len(pool)])[0]
        server.probabilities(estimate, bank)
        at += 1
    harness.sync(device)
    setup_s = phases.mark("warm_requests") - t_start

    latencies: tp.List[float] = []
    enqueue: tp.List[float] = []
    events: tp.List[tuple] = []
    launches = c.program.launch_counts()
    with tracing.profiled(trace) as prof:
        with harness.span(tracing.WINDOW, trace):
            t0 = time.perf_counter()
            i = 0
            while time.perf_counter() - t0 < seconds:
                t = time.perf_counter()
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(3)] \
                    if trace and device.type == "cuda" else []
                which = (at + i) % len(pool)
                with harness.span("bench.request", trace):
                    if marks:
                        marks[0].record()
                    with harness.span("bench.forward", trace):
                        estimate = server.forward_batch(requests[which])[0]
                    if marks:
                        marks[1].record()
                    with harness.span("bench.scoring", trace):
                        probs = server.probabilities(estimate, bank)
                    if marks:
                        marks[2].record()
                    enqueue.append(time.perf_counter() - t)
                    harness.sync(device)
                latencies.append(time.perf_counter() - t)
                sample.offer(i, (which, estimate, probs))
                if marks:
                    events.append(tuple(marks))
                i += 1
            t1 = time.perf_counter()
    harness.check_modules()
    peak = harness.peak(device)
    launches = harness.delta(c.program.launch_counts(), launches)
    cuda_ms = {"forward": [a.elapsed_time(b) for a, b, _ in events],
               "scoring": [b.elapsed_time(c) for _, b, c in events]}
    kept = sample.kept()
    del server, estimate, probs, events, sample
    harness.free(device)

    readings, failed, cache = [], 0, {}
    for _, which, estimate, probs in kept:
        if not (torch.isfinite(estimate).all()
                and torch.isfinite(probs).all()):
            failed += 1
        if which not in cache:
            cache[which] = _reference(ref, params, stats, m, pool[which],
                                      norm, bank)
        readings.append(check.row_gaps(estimate, probs, *cache[which]))
    del kept
    n = len(latencies)
    result = dict(
        attempted=n, failed=failed, memory_peak_bytes=peak,
        numbers=check.worst(readings) if readings else {},
        diagnostics={"request_median_ms":
                     statistics.median(latencies) * 1e3,
                     "enqueue_median_ms": statistics.median(enqueue) * 1e3,
                     "setup_phases_s": phases.seconds},
        end_to_end={
            "eval_windows_per_s": n * rows / (t1 - t0),
            "eval_request_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
            "setup_s": setup_s})
    if trace:
        result["record"] = harness.Record(c, tracing.reduce(prof), n, rows,
                                          {}, cuda_ms, launches)
        # the harness's own CUDA events around each call, beside the
        # program's spans that the readers take
        result["diagnostics"].update(
            {f"{part}_event_median_ms": statistics.median(times)
             for part, times in cuda_ms.items() if times})
    return result


def readings(c: spec.Cell, seed: int, device: torch.device,
             what: tp.Sequence[str]) -> tp.Iterator[tp.Tuple[str, dict]]:
    """``benchmark.control``'s readings of this loop, each against the
    float32 reference over one request of each pool batch: ``program``
    (``Server.forward_batch`` and ``Server.probabilities``), ``control``
    (the reference one precision lower), ``fault:half_batch`` (half the
    rows of each request left unanswered, their estimates zero) and
    ``fault:altered`` (one row's probabilities those of another row),
    planted around the reference."""
    m, mix, ref = c.config["model"], c.traffic, c.reference
    params, stats, norm, pool, bank = _inputs(c, seed, device)
    truth = [_reference(ref, params, stats, m, b, norm, bank) for b in pool]
    if "program" in what:
        server = c.program.server(c.config, params, stats, norm, device)
        got = []
        for batch in pool:
            est = server.forward_batch(types.SimpleNamespace(**batch))[0]
            got.append((est, server.probabilities(est, bank)))
        del server
        yield "program", check.worst(check.row_gaps(*g, *t)
                                     for g, t in zip(got, truth))
        del got
        harness.free(device)
    if "control" in what:
        yield "control", check.worst(
            check.row_gaps(*_reference(ref, params, stats, m, b, norm, bank,
                                       c.config["control"]), *t)
            for b, t in zip(pool, truth))
    if "faults" in what:
        half = mix["rows"] // 2
        cut_readings = []
        for est, probs in truth:
            cut = est.clone()
            cut[half:] = 0
            with torch.no_grad(), harness.fp32_flags():
                cut_readings.append(check.row_gaps(
                    cut, ref.probabilities(cut, bank), est, probs))
        yield "fault:half_batch", check.worst(cut_readings)
        yield "fault:altered", check.worst(
            check.row_gaps(est, probs.roll(1, dims=0), est, probs)
            for est, probs in truth)


def unit_flops(c: spec.Cell) -> int:
    """FLOPs of one request: the eval-mode forward and the scores against
    the bank."""
    ref, m, mix = c.reference, c.config["model"], c.traffic
    batch, norm, params, stats = flops.meta_inputs(ref, m, mix["rows"])

    def request() -> None:
        with torch.no_grad():
            estimate, _ = ref.encode(params, stats, m, batch, norm, False,
                                     None)
            bank = torch.zeros(mix["candidates"], *estimate.shape[1:],
                               device="meta")
            ref.probabilities(estimate, bank)
    return flops.count(request)
