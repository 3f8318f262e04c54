"""Device ms of a request's scoring (``Server.probabilities``: the
inverse norms, ``nt_matmul`` and the softmax): CUDA events the harness
records around the call, the median over the traced window's requests."""

import statistics


def read(rec):
    times = rec.cuda_ms.get("scoring")
    return statistics.median(times) if times else None
