"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit).
float32 is the TF32 tensor rate counted once: the port runs its float32
kernels on the tensor cores."""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time: operations over the peak or bytes over HBM's rate,
    whichever is larger."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
