"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense
rates without sparsity, at the full power limit of 700 W)."""

BF16_FLOPS = 989e12  # tensor cores, bfloat16
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # 80 GB of HBM3
SOURCE = "NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense"
