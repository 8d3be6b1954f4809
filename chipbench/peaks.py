"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit).  A card set below that
limit runs slower under load; the run prints its limit beside the
numbers."""

FLOPS = {
    "fp32": 67e12,      # outside the tensor cores
    "tf32": 495e12,
    "bf16": 989e12,
    "fp16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
