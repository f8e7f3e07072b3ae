"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, at
the 700 W power limit)."""
H100_HBM_BYTES_PER_S = 3.35e12
