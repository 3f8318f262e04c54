"""The whole step's (or request's) share of the card's dense peak: the
plain reference's FLOPs of the traced window's steps or requests over its
length and the peak of the compute type the configuration states
(``harness.peaks.FLOPS``). The FLOPs are the loop's sum over the units'
shapes (``Record.flops``) where it gives one, else one unit's at the
cell's shapes (the loop's ``unit_flops``) times the units."""

from benchmark.harness import peaks


def read(rec):
    if not rec.units:
        return None
    work = rec.flops if rec.flops is not None else \
        rec.cell.loop.unit_flops(rec.cell) * rec.units
    peak = peaks.FLOPS[rec.cell.config["peak"]]
    return 100 * work / rec.trace.window_s / peak
