"""Host ms a step inside the program's span ``bm.step`` (``Solver.step``,
outermost): the enqueue measured in the program, the twin of
``host_dispatch_ms``, which the harness takes around the call."""

from benchmark.harness import spans


def read(rec):
    return spans.host_ms(rec, "step")
