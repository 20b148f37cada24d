"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Copied, frozen, from
chip_smoke.py (HBM_BYTES_PER_S, PEAK_FLOPS)."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def peak_flops(dtype: str) -> float:
    """FLOP/s of the card's peak for a configuration's compute dtype."""
    return PEAK_FLOPS[dtype]
