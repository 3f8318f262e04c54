"""Kernel launches a step or request: the runtime's launch calls
(``cudaLaunchKernel`` and its kin, ``spans.LAUNCHES``) that start inside
one of the program's outermost spans, on any thread, over the window's
units."""

from benchmark.harness import spans


def read(rec):
    return spans.calls(rec, spans.LAUNCHES)
