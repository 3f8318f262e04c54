"""Device ms of a request's forward (``Server.forward_batch``): CUDA
events the harness records around the call, the median over the traced
window's requests."""

import statistics


def read(rec):
    times = rec.cuda_ms.get("forward")
    return statistics.median(times) if times else None
