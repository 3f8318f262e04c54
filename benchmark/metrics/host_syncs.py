"""Host synchronizations a step or request: the runtime's calls that
wait for the device (``spans.SYNCS``) that start inside one of the
program's outermost spans, on any thread, over the window's units. A
request's closing synchronize is the harness's and lies outside them."""

from benchmark.harness import spans


def read(rec):
    return spans.calls(rec, spans.SYNCS)
