"""Host ms a step inside the program's span ``bm.optimizer`` (Adam's
``step()``)."""

from benchmark.harness import spans


def read(rec):
    return spans.host_ms(rec, "optimizer")
