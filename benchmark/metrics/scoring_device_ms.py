"""Device ms a request of the program's span ``bm.scoring``: the counter
``device_us.scoring`` (CUDA events at the span's start and end on the
stream, idle between them included) over the window's requests; the
mean."""

from benchmark.harness import spans


def read(rec):
    return spans.device_ms(rec, "scoring")
