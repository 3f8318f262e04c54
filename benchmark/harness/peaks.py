"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W power limit)."""

#: dense tensor-core FLOP/s by the compute type a configuration's
#: ``peak`` names
FLOPS = {"bfloat16": 989e12, "tf32": 495e12}
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
