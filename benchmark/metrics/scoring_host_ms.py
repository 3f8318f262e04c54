"""Host ms a request inside the program's span ``bm.scoring``
(``Server.probabilities``: the inverse norms, ``nt_matmul`` and the
softmax)."""

from benchmark.harness import spans


def read(rec):
    return spans.host_ms(rec, "scoring")
