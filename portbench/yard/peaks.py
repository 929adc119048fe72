"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit) and the least time of a piece of work."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp8": 1979e12}


def bound_s(nbytes: float, flops: float, fmt: str = "fp32") -> float:
    """Least seconds for the work: bytes at the HBM rate or operations at
    the peak rate of ``fmt``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[fmt])
