"""Host ms a step inside the program's span ``bm.backward`` (the loss's
``backward()``: autograd enqueues the gradients on its own thread while
this one waits)."""

from benchmark.harness import spans


def read(rec):
    return spans.host_ms(rec, "backward")
