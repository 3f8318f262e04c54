"""The whole step's (or request's) share of the card's dense peak: the
plain reference's FLOPs of one at the cell's shapes (the cell's loop's
``unit_flops``), times the steps or requests of the traced window, over
its length and the peak of the compute type the configuration states
(``harness.peaks.FLOPS``)."""

from benchmark.harness import peaks


def read(rec):
    if not rec.units:
        return None
    per_unit = rec.cell.loop.unit_flops(rec.cell)
    peak = peaks.FLOPS[rec.cell.config["peak"]]
    return 100 * per_unit * rec.units / rec.trace.window_s / peak
