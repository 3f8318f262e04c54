"""Host ms a step inside the program's span ``bm.step`` (``Solver.step``,
outermost): the enqueue measured in the program. The harness's host
clock around the call prints beside it as the diagnostic
``host_dispatch_ms``."""

from benchmark.harness import spans


def read(rec):
    return spans.host_ms(rec, "step")
