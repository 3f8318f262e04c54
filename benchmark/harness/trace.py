"""The traced window: ``torch.profiler`` over the same loop, reduced from
its raw events to what the per-layer readers take.

Each device activity (kernel, copy, fill; not the device-side mirrors of
host ranges) keeps its name, its interval
and the host operation that launched it (the profiler links each to the
innermost operation that was running when it was enqueued). The window
is the harness's ``bench.window`` range; activity outside it is cut off.
The device is busy in the union of the activities' intervals; each idle
gap is put down to what the host was doing when it began: the
innermost harness range (``bench.*``) and the innermost operation then
running on any thread."""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import typing as tp

import torch

#: the harness's own ranges start with this
PREFIX = "bench."
WINDOW = PREFIX + "window"
#: gaps this short are counted together; longer ones are each put down
#: to the host's work (at most MAX_LABELLED of them, the longest)
SHORT_GAP_NS = 10_000
MAX_LABELLED = 5000
#: entries of each list of the breakdown
TOP = 10


@dataclasses.dataclass
class Activity:
    name: str
    op: str
    start: int
    end: int


@dataclasses.dataclass
class Trace:
    """The window's device activities and its host ranges, in ns."""

    start: int
    end: int
    activities: tp.List[Activity]
    host: tp.List[tp.Tuple[int, int, str]]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy(self) -> tp.List[tp.Tuple[int, int]]:
        """The union of the activities' intervals, in order."""
        spans = sorted((a.start, a.end) for a in self.activities)
        out: tp.List[tp.List[int]] = []
        for lo, hi in spans:
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return [(lo, hi) for lo, hi in out]

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy()) / 1e9

    def device_seconds(self, match: tp.Callable[[Activity], bool]) -> float:
        return sum(a.end - a.start for a in self.activities if match(a)) / 1e9

    def gaps(self) -> tp.List[tp.Tuple[int, int]]:
        out, at = [], self.start
        for lo, hi in self.busy():
            if lo > at:
                out.append((at, lo))
            at = max(at, hi)
        if self.end > at:
            out.append((at, self.end))
        return out

    def _host_at(self, t: int, starts: tp.List[int]) -> str:
        """'range > op': the innermost harness range and the innermost
        other operation running at `t`."""
        span, op, span_start, op_start = "", "", -1, -1
        i = bisect.bisect_right(starts, t)
        for lo, hi, name in reversed(self.host[max(0, i - 4000):i]):
            if hi <= t:
                continue
            if name.startswith(PREFIX):
                if lo > span_start:
                    span, span_start = name, lo
            elif lo > op_start:
                op, op_start = name, lo
        return " > ".join(x for x in (span, op) if x) or "host idle"

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest
        idle gaps by what the host was doing, TOP of each, in seconds."""
        ops: tp.Dict[str, float] = collections.Counter()
        for a in self.activities:
            ops[a.name[:160]] += (a.end - a.start) / 1e9
        idle: tp.Dict[str, float] = collections.Counter()
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        starts = [lo for lo, _, _ in self.host]
        for n, (lo, hi) in enumerate(gaps):
            if hi - lo < SHORT_GAP_NS or n >= MAX_LABELLED:
                idle[f"gaps under {SHORT_GAP_NS // 1000} us, or past the "
                     f"{MAX_LABELLED} longest"] += (hi - lo) / 1e9
            else:
                idle[self._host_at(lo, starts)] += (hi - lo) / 1e9
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}


@contextlib.contextmanager
def profiled(enabled: bool) -> tp.Iterator[tp.Any]:
    """A profiler of host and CUDA activity when `enabled`, else None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def reduce(prof: tp.Any) -> Trace:
    """The window's `Trace` from a finished profiler's raw events."""
    events = prof.profiler.kineto_results.events()
    names: tp.Dict[int, str] = {}
    ranges: tp.Set[str] = set()
    host, device = [], []
    start = end = None
    for e in events:
        lo = e.start_ns()
        hi = lo + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            name = e.name()
            if e.linked_correlation_id() == 0:
                # an operation or range (a runtime call links to one)
                names[e.correlation_id()] = name
            if e.is_user_annotation():
                ranges.add(name)
            if name == WINDOW:
                start, end = lo, hi
            host.append((lo, hi, name))
        elif not e.is_user_annotation():
            device.append((e.name(), e.linked_correlation_id(), lo, hi))
    if start is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    # a host range is mirrored on the device's timeline: not an activity
    activities = [Activity(name, names.get(corr, ""), max(lo, start),
                           min(hi, end))
                  for name, corr, lo, hi in device
                  if hi > start and lo < end and name not in ranges]
    host.sort()
    return Trace(start, end, activities, host)
