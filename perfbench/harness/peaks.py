"""Published peaks of one NVIDIA H100 SXM5 80GB ("NVIDIA H100 80GB HBM3"),
NVIDIA's data sheet, at the full 700 W power limit: float32 outside the
tensor cores (the program runs with TF32 off) and HBM3's rate."""

H100_F32_FLOPS = 67e12
H100_HBM_BYTES_S = 3.35e12
