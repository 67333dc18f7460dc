"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit), and the least time a piece of work
could take on it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12       # tensor cores, bf16 and fp16
TF32_OPS_PER_S = 495e12       # tensor cores, tf32
FP32_OPS_PER_S = 67e12        # CUDA cores, fp32


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of the operations' time at the peak of ``dtype``'s
    products and the bytes' time at the memory's peak. Float32 work
    takes the faster of the CUDA cores and three TF32 products (3xTF32,
    the port's float32 kernels), as the port's kernel table has it."""
    if dtype == "float32":
        ops = min(flops / FP32_OPS_PER_S, 3 * flops / TF32_OPS_PER_S)
    else:
        ops = flops / BF16_OPS_PER_S
    return max(ops, nbytes / HBM_BYTES_PER_S)
