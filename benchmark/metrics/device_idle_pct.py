"""The share of the traced window in which no device activity ran: one
minus the union of the activities' intervals over the window."""


def read(rec):
    window = rec.trace.window_s
    if window <= 0:
        return None
    return 100 * (1 - rec.trace.busy_s / window)
