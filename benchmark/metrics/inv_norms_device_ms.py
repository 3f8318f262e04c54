"""Device ms a request of the program's span ``bm.inv_norms``
(``losses.block_inv_norms`` over the bank of candidates): the counter
``device_us.inv_norms`` over the window's requests."""

from benchmark.harness import spans


def read(rec):
    return spans.device_ms(rec, "inv_norms")
