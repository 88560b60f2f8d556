"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). A run records the card's power limit beside
any share of these."""

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
}
