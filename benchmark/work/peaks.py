"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit): float32 outside the tensor cores, bf16 on the
tensor cores, and HBM3 bandwidth.  Copied from `chip_smoke.py`."""

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS
             ) -> float:
    """The least milliseconds the chip could take: the larger of bytes
    over the bandwidth and operations over `peak`."""
    return max(nbytes / PEAK_BYTES, flops / peak) * 1e3
