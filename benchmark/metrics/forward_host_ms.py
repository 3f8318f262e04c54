"""Host ms a step or request inside the program's span ``bm.forward``
(``Solver._forward``: the normalize kernel, the model, the feature
model)."""

from benchmark.harness import spans


def read(rec):
    return spans.host_ms(rec, "forward")
