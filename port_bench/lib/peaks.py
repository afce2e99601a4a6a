"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W), frozen from ``chip_smoke.py``.  float32 with
TF32 off runs on the CUDA cores: 67 TFLOP/s.  A run prints the card's
power limit beside any share of these."""
from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of operations over
    peak FLOP/s and bytes over peak bytes/s."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
