"""The program's spans in a traced window, for the per-layer readers.

The program's ``tracing`` module opens the profiler range ``bm.<name>``
around each layer (in ``Record.trace.host``) and folds each span's CUDA
event pair into the counter ``device_us.<name>`` (in ``Record.launches``,
the program's counters over the window). A runtime call belongs to the
spans when it starts inside one, found by time and not by thread:
autograd enqueues the backward from a thread of its own. A program
without the spans gives None, never a zero."""

from __future__ import annotations

import bisect
import typing as tp

#: the program's spans' ranges start with this
PREFIX = "bm."
#: runtime calls that launch a kernel
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"})
#: runtime calls that wait for the device (``cudaMemcpy`` is the blocking
#: copy; ``cudaMemcpyAsync`` is not among them)
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def intervals(trace: tp.Any, name: tp.Optional[str] = None
              ) -> tp.List[tp.Tuple[int, int]]:
    """(start, end) ns of the window's ranges ``bm.<name>``, or of every
    ``bm.*`` range when `name` is None."""
    return [(lo, hi) for lo, hi, label in trace.host
            if (label == PREFIX + name if name is not None
                else label.startswith(PREFIX))
            and trace.start <= lo and hi <= trace.end]


def host_ms(rec: tp.Any, name: str) -> tp.Optional[float]:
    """Host ms a unit (step or request) inside ``bm.<name>``."""
    found = intervals(rec.trace, name)
    if not found or not rec.units:
        return None
    return sum(hi - lo for lo, hi in found) / rec.units / 1e6


def device_ms(rec: tp.Any, name: str) -> tp.Optional[float]:
    """Device ms a unit from ``bm.<name>``'s start to its end on the
    stream (the counter ``device_us.<name>``)."""
    us = rec.launches.get(f"device_us.{name}")
    if us is None or not rec.units:
        return None
    return us / rec.units / 1e3


def outermost(trace: tp.Any) -> tp.List[tp.Tuple[int, int]]:
    """The union of the window's ``bm.*`` ranges: the outermost spans,
    those that overlap merged, in order."""
    out: tp.List[tp.List[int]] = []
    for lo, hi in sorted(intervals(trace)):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def calls(rec: tp.Any, names: tp.AbstractSet[str]) -> tp.Optional[float]:
    """Runtime calls named in `names` a unit that start inside an
    outermost span, on any thread."""
    spans = outermost(rec.trace)
    if not spans or not rec.units:
        return None
    starts = [lo for lo, _ in spans]
    n = 0
    for lo, _, label in rec.trace.host:
        if label in names:
            i = bisect.bisect_right(starts, lo) - 1
            if i >= 0 and lo <= spans[i][1]:
                n += 1
    return n / rec.units
