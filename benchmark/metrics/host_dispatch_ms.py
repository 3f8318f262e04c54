"""Host time per call of the program's step (``Solver.step``) with no
synchronize: the enqueue time, the harness's host clock around each call
summed over the window and divided by the calls."""


def read(rec):
    seconds = rec.host_s.get("solver.step")
    if seconds is None or not rec.units:
        return None
    return seconds / rec.units * 1e3
