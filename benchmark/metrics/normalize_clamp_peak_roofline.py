"""``normalize_clamp_peak``'s share of its roofline: the least time the
card could take for one call (every byte it must move once at the HBM
rate: the MEG in the wire dtype, the recordings' center and scale
tables, the recording index, the fp32 output and the peaks) over the
kernel's device time a call (its activities in the trace over the
program's launch counter)."""

from benchmark.harness import peaks

KERNEL = "normalize_clamp_peak"
WIRE_BYTES = {"bfloat16": 2, "float32": 4}


def call_bytes(rows, sensors, samples, recordings, wire_bytes):
    """Bytes one call must read and write at these shapes."""
    elements = rows * sensors * samples
    return (elements * wire_bytes + 2 * recordings * sensors * 4 + rows * 8
            + elements * 4 + rows * 4)


def read(rec):
    calls = rec.launches.get(KERNEL, 0)
    seconds = rec.trace.device_seconds(lambda a: KERNEL in a.name)
    if not calls or not seconds:
        return None
    m = rec.model
    least = call_bytes(rec.rows, m["sensors"], m["window_samples"],
                       m["recordings"],
                       WIRE_BYTES[rec.cell.config["wire_dtype"]]
                       ) / peaks.HBM_BYTES_PER_S
    return 100 * least / (seconds / calls)
