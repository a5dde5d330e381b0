"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
