"""Device ms a step or request of the program's span ``bm.forward``: the
counter ``device_us.forward`` (CUDA events the program records on the
stream at the span's start and end, idle between them included) over
the window's units; the mean."""

from benchmark.harness import spans


def read(rec):
    return spans.device_ms(rec, "forward")
