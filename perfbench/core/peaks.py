"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick of every roofline and
MFU the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "fp32": 67e12,          # outside the tensor cores
    "tf32_dense": 495e12,
    "bf16_dense": 989e12,
    "fp8_dense": 1979e12,
}
