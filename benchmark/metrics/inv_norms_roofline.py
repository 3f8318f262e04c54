"""``inv_norms``' share of its roofline in a retrieval request: the least
time of one call, the bank of candidates in the scores' dtype read once
and its fp32 inverse norms written once at the HBM rate, over the device
time of the kernels the call launches (the row pass and, when rows are
split, the split sum) a call. Nothing to read where the program has no
such kernel."""

from benchmark.harness import peaks

KERNELS = ("inv_norms_rows", "inv_norms_splits")
ITEM_BYTES = {"bfloat16": 2, "float32": 4}


def least_seconds(n, k, dtype):
    """Seconds of the inverse norms of an [n, k] bank at the HBM rate."""
    return (n * k * ITEM_BYTES[dtype] + n * 4) / peaks.HBM_BYTES_PER_S


def read(rec):
    calls = rec.launches.get("inv_norms", 0)
    seconds = rec.trace.device_seconds(
        lambda a: any(k in a.name for k in KERNELS))
    if not calls or not seconds:
        return None
    model = rec.model
    k = model["features"] * (model["window_samples"]
                             - model["offset_samples"])
    least = least_seconds(rec.cell.traffic["candidates"], k,
                          rec.cell.config["scores_dtype"])
    return 100 * least / (seconds / calls)
