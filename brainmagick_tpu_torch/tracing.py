"""The program's spans and counters, at its layer boundaries.

``span(name)`` marks a layer: the train step and its forward, loss,
backward and optimizer; a request's scoring, its inverse norms,
``nt_matmul`` and softmax; a collective. As a context manager or a
decorator it costs one flag test unless a ``torch.profiler`` runs. Under
one it is the range ``bm.<name>`` in the profiler's trace, stamped on the
clock of the device activities there; with CUDA initialised it also
records a CUDA event on the current stream at its entry and at its exit,
and adds the time between them (the device's time from reaching the
span's start to reaching its end, idle inside it included) to the counter
``device_us.<name>``. Pairs are folded in when their end event has
completed, checked with ``Event.query`` at each outermost span's exit and
in ``counters()``: nothing waits on the device. While ``torch.compile``
or ``torch.export`` traces, spans are off, so that no profiler op enters
a graph.

``count(name, n)`` adds to a counter, with or without a profiler: the
host's copies to the card and their bytes (``h2d.copies``,
``h2d.bytes``), the host's wait on the loader (``loader.wait_us``).
``counters()`` is a snapshot of them all and ``reset()`` clears them;
``ops.launch_counts()`` returns them beside the kernels' launches.
"""

from __future__ import annotations

import collections
import functools
import threading
import typing as tp

import torch
from torch.profiler import record_function

#: the profiler range of span `name` is PREFIX + name
PREFIX = "bm."

_counters: tp.Counter[str] = collections.Counter()
#: (name, start, end) CUDA event pairs whose end had not completed yet
_pending: tp.List[tuple] = []
#: spans open on any thread: with none, a span's exit returns at once
_live = 0
_lock = threading.Lock()
_profiler_enabled = torch.autograd._profiler_enabled


class _Open(threading.local):
    """Each thread's open spans, outermost first: (span, range, start
    event or None)."""

    def __init__(self) -> None:
        self.spans: tp.List[tuple] = []


_open = _Open()


class _Span:
    """One name's span; stateless, so one object serves every call, on
    every thread (each thread's open spans are in ``_open``)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.label = PREFIX + name

    def __enter__(self) -> None:
        global _live
        if not _profiler_enabled() or torch.compiler.is_compiling():
            return
        marker = record_function(self.label)
        marker.__enter__()
        start = None
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        _open.spans.append((self, marker, start))
        with _lock:
            _live += 1

    def __exit__(self, *exc: tp.Any) -> None:
        global _live
        if not _live:
            return
        spans = _open.spans
        if not spans or spans[-1][0] is not self:
            return
        _, marker, start = spans.pop()
        with _lock:
            _live -= 1
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                _pending.append((self.name, start, end))
        marker.__exit__(*exc)
        if not spans:
            _resolve()

    def __call__(self, fn: tp.Callable) -> tp.Callable:
        @functools.wraps(fn)
        def spanned(*args: tp.Any, **kwargs: tp.Any) -> tp.Any:
            with self:
                return fn(*args, **kwargs)
        return spanned


@functools.cache
def span(name: str) -> _Span:
    """The span ``bm.<name>``: ``with span(name):`` or ``@span(name)``."""
    return _Span(name)


def _resolve() -> None:
    """Fold the event pairs whose end has completed into ``device_us.*``."""
    with _lock:
        waiting = []
        for name, start, end in _pending:
            if end.query():
                _counters[f"device_us.{name}"] += start.elapsed_time(end) * 1e3
            else:
                waiting.append((name, start, end))
        _pending[:] = waiting


def count(name: str, n: float = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counters[name] += n


def counters() -> tp.Dict[str, float]:
    """{name: value} of every counter, the completed spans' device time
    folded in first."""
    _resolve()
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Clear every counter, and the spans' pairs not folded in yet."""
    with _lock:
        _counters.clear()
        _pending.clear()
