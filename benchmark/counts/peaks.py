"""The card's published peaks and the least time of an operation.

NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 989 TFLOP/s in bf16
on the tensor cores, 67 TFLOP/s in float32 on the CUDA cores (TF32 off),
3.35 TB/s of HBM3. An operation's least time is the larger of its bytes
(each input read once, each output written once) over the bandwidth and its
operations over the peak of the type it computes in.
"""

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "f32": 4}


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """Seconds: max(operations / peak, bytes / bandwidth)."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
