"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12,
         "int8": 1979e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of bytes over the
    memory bandwidth and operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype])
