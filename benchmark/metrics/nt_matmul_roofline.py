"""``nt_matmul``'s share of its roofline in a retrieval request: the
least time of one call, the larger of 2 M N K operations at the scores'
dense peak and the operands read once and the fp32 scores written once
at the HBM rate, over the device time of every kernel the call launches
(the GEMM's tiles and the split sum) a call."""

from benchmark.harness import peaks

KERNELS = ("nt_matmul_tiles", "sum_splits")
OPERAND_BYTES = {"bfloat16": 2, "float32": 4}
#: an fp32 product runs as three TF32 ones
PEAK = {"bfloat16": peaks.FLOPS["bfloat16"], "float32": peaks.FLOPS["tf32"] / 3}


def least_seconds(m, n, k, dtype):
    """(seconds, "operations" or "bytes") of [m, k] x [n, k] -> [m, n]."""
    by_ops = 2 * m * n * k / PEAK[dtype]
    by_bytes = ((m + n) * k * OPERAND_BYTES[dtype] + m * n * 4) \
        / peaks.HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def read(rec):
    calls = rec.launches.get("nt_matmul", 0)
    seconds = rec.trace.device_seconds(lambda a: any(k in a.name for k in KERNELS))
    if not calls or not seconds:
        return None
    model = rec.model
    k = model["features"] * (model["window_samples"]
                             - model["offset_samples"])
    least, _ = least_seconds(rec.rows, rec.cell.traffic["candidates"], k,
                             rec.cell.config["scores_dtype"])
    return 100 * least / (seconds / calls)
