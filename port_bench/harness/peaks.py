"""The chip's published peaks (NVIDIA H100 SXM data sheet, dense, at the
700 W limit), and the least time of a piece of work under them.

float32 is computed by the port's kernels as three TF32 passes (tf32x3) to
keep float32's accuracy, so its peak is the TF32 rate over three.
"""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(flops, nbytes, dtype):
    """max(operations / peak, bytes / HBM rate), in seconds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
