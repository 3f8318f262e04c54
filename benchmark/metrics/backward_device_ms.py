"""Device ms a step of the program's span ``bm.backward``: the counter
``device_us.backward`` (CUDA events at the span's start and end on the
stream, idle between them included) over the window's steps."""

from benchmark.harness import spans


def read(rec):
    return spans.device_ms(rec, "backward")
