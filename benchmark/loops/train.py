"""The ``train`` loop: closed loop, one host thread. Set-up builds the
program's trainer (the cell's program entry's ``trainer``), drives it
through the mix's ``check_steps`` (the steps the reference follows) and
``warm_steps``, and hands that same object to the window, which
dispatches ``Solver.step`` back to back over the pool of batches with no
synchronize until it closes. A unit is one step of the configuration's
batch.

The mix's keys: ``pool_batches`` (distinct seeded batches resident on the
card in the wire dtype, rotated each step), ``check_steps``,
``warm_steps``."""

from __future__ import annotations

import time
import typing as tp
from unittest import mock

import torch

from benchmark.harness import cell as harness
from benchmark.harness import check, flops, seeded, spec
from benchmark.harness import trace as tracing


def program_readings(entry: tp.Any, trainer: tp.Any,
                     pool: tp.Sequence[dict], weights: dict, steps: int
                     ) -> dict:
    """The program's first `steps` train steps on pool batches 0, 1, ...
    through ``Solver.step``, in the reference's ``train_steps`` layout:
    each step's loss, the first gradient's norm per leaf as Adam received
    it (its first moment after one step over 1 - beta1) and each leaf's
    change from `weights` after the last step; `entry` is the program
    entry that built `trainer`."""
    solver = trainer.solver
    leaves = entry.trained_leaves(trainer)
    rows = pool[0]["meg"].shape[0]
    ones = torch.ones(rows, dtype=torch.float32, device=pool[0]["meg"].device)
    losses, out = [], {}
    for i in range(steps):
        losses.append(solver.step(pool[i % len(pool)], ones, True)["loss"])
        if i == 0:
            beta1 = trainer.optimizer.param_groups[0]["betas"][0]
            state = trainer.optimizer.state
            out["grad"] = {k: float(state[p]["exp_avg"].norm() / (1 - beta1))
                           if p in state else 0. for k, p in leaves.items()}
    out["loss"] = [float(x) for x in losses]
    out["change"] = {k: float((p.detach() - weights[k]).norm())
                     for k, p in leaves.items()}
    return out


def reference_readings(ref: tp.Any, m: dict, params: dict, stats: dict,
                       pool: tp.Sequence[dict], norm: dict, seed: int,
                       steps: int, rounding: str = "float32") -> dict:
    """The reference's first `steps` steps from the same weights, inputs
    and merger-dropout centres, TF32 off."""
    device = pool[0]["meg"].device
    centers = [c.to(device) for c in seeded.centers(seed, steps)]
    with harness.fp32_flags():
        return ref.train_steps(params, stats, m, list(pool[:steps]), norm,
                               centers, ref.ROUNDINGS[rounding])


def window(c: spec.Cell, seed: int, seconds: float, trace: bool,
           device: torch.device, t_start: float) -> dict:
    m, mix, ref = c.config["model"], c.traffic, c.reference
    wire = harness.DTYPES[c.config["wire_dtype"]]
    rows, n_check = m["batch_size"], mix["check_steps"]
    phases = harness.Phases(t_start)
    phases.mark("start")
    params, stats = seeded.weights(ref, m, seed, device)
    norm = seeded.tables(ref, m, seed, device)
    pool = seeded.batches(m, norm, rows, mix["pool_batches"], seed, device,
                          wire)
    harness.sync(device)
    phases.mark("inputs")
    trainer = c.program.trainer(c.config, params, stats, norm, device,
                                seeded.stream(seed, seeded.DROPOUT))
    solver = trainer.solver
    phases.mark("program")
    ones = torch.ones(rows, dtype=torch.float32, device=device)
    prog = program_readings(c.program, trainer, pool, params, n_check)
    phases.mark("checked_steps")
    at = n_check
    for _ in range(mix["warm_steps"]):
        solver.step(pool[at % len(pool)], ones, True)
        at += 1
    harness.sync(device)
    setup_s = phases.mark("warm_steps") - t_start

    losses, dispatch = [], 0.
    launches = c.program.launch_counts()
    with tracing.profiled(trace) as prof:
        with harness.span(tracing.WINDOW, trace):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                t = time.perf_counter()
                with harness.span("bench.step", trace):
                    out = solver.step(pool[at % len(pool)], ones, True)
                dispatch += time.perf_counter() - t
                losses.append(out["loss"])
                at += 1
            harness.sync(device)
            t1 = time.perf_counter()
    harness.check_modules()
    steps = len(losses)
    peak = harness.peak(device)
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    launches = harness.delta(c.program.launch_counts(), launches)
    del trainer, solver, out, losses
    harness.free(device)

    truth = reference_readings(ref, m, params, stats, pool, norm, seed,
                               n_check)
    result = dict(attempted=steps, failed=failed, memory_peak_bytes=peak,
                  numbers=check.train_numbers(prog, truth),
                  diagnostics={"host_dispatch_ms": dispatch / steps * 1e3,
                               "setup_phases_s": phases.seconds},
                  end_to_end={"train_samples_per_s": steps * rows / (t1 - t0),
                              "setup_s": setup_s})
    if trace:
        result["record"] = harness.Record(
            c, tracing.reduce(prof), steps, rows, {"solver.step": dispatch},
            {}, launches)
    return result


def _half_batch(ref: tp.Any) -> tp.ContextManager:
    """The CLIP loss averaged over the first half of the batch's rows."""
    def half(estimate: torch.Tensor, targets: torch.Tensor,
             rnd: tp.Callable = ref.identity) -> torch.Tensor:
        logp = torch.log_softmax(ref.clip_scores(estimate, targets, rnd),
                                 dim=1)
        return -torch.diagonal(logp)[:estimate.shape[0] // 2].mean()
    return mock.patch.object(ref, "clip_loss", half)


def _unchanged(ref: tp.Any) -> tp.ContextManager:
    """No update: Adam's step leaves every leaf as it was."""
    return mock.patch.object(ref.Adam, "step", lambda self, *args: None)


#: faults planted around the reference put in the program's place
FAULTS: tp.Dict[str, tp.Callable[[tp.Any], tp.ContextManager]] = {
    "half_batch": _half_batch, "unchanged": _unchanged}


def readings(c: spec.Cell, seed: int, device: torch.device,
             what: tp.Sequence[str]) -> tp.Iterator[tp.Tuple[str, dict]]:
    """``benchmark.control``'s readings of this loop, each against the
    float32 reference: ``program`` (the checked steps as a run makes
    them), ``control`` (the reference one precision lower) and
    ``fault:<name>`` (each of FAULTS)."""
    m, mix, ref = c.config["model"], c.traffic, c.reference
    steps = mix["check_steps"]
    params, stats = seeded.weights(ref, m, seed, device)
    norm = seeded.tables(ref, m, seed, device)
    pool = seeded.batches(m, norm, m["batch_size"], steps, seed, device,
                          harness.DTYPES[c.config["wire_dtype"]])
    truth = reference_readings(ref, m, params, stats, pool, norm, seed,
                               steps)
    if "program" in what:
        trainer = c.program.trainer(c.config, params, stats, norm, device,
                                    seeded.stream(seed, seeded.DROPOUT))
        got = program_readings(c.program, trainer, pool, params, steps)
        del trainer
        harness.free(device)
        yield "program", check.train_numbers(got, truth)
    if "control" in what:
        got = reference_readings(ref, m, params, stats, pool, norm, seed,
                                 steps, c.config["control"])
        yield "control", check.train_numbers(got, truth)
    if "faults" in what:
        for name, fault in FAULTS.items():
            with fault(ref):
                got = reference_readings(ref, m, params, stats, pool, norm,
                                         seed, steps)
            yield f"fault:{name}", check.train_numbers(got, truth)


def unit_flops(c: spec.Cell) -> int:
    """FLOPs of one train step: the forward, the CLIP loss and the
    backward."""
    ref, m = c.reference, c.config["model"]
    batch, norm, params, stats = flops.meta_inputs(ref, m, m["batch_size"])
    center = torch.zeros(2, device="meta")
    return flops.count(lambda: ref.clip_loss(*ref.encode(
        params, stats, m, batch, norm, True, center)).backward())

