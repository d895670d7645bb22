"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates at the
card's full power limit of 700 W: the yardstick of every roofline share
and utilisation the benchmark reports."""
H100 = {
    "bf16_flops": 989e12,      # dense bf16 tensor-core operations a second
    "hbm_bytes_s": 3.35e12,    # HBM3 bytes a second
}
