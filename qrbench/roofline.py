"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates) and the
least time a piece of work could take on it.

A roofline share is that least time over the measured device time: the
larger of operations over the peak of the work's precision and bytes
(each input read once, each output written once) over HBM's rate.  The
peaks assume the full 700 W power limit; the run prints the card's limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "float32": 67e12,       # FP32 outside the tensor cores ("highest")
    "tf32": 494.7e12,       # TF32 tensor cores, dense
    "float64": 67e12,       # FP64 tensor cores
    "bfloat16": 989.4e12,
}
ELEMENT_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}


def peak(config: dict) -> float:
    """Peak FLOP/s of a configuration's GEMMs: its dtype's, or TF32's where
    its precision is "tf32" or "high" (each of 3xTF32's products is TF32)."""
    q = config["qr_config"]
    if config["dtype"] == "float32" and q["precision"] in ("tf32", "high"):
        return PEAK_FLOPS["tf32"]
    return PEAK_FLOPS[config["dtype"]]


def least_seconds(flops: float, nbytes: float, flops_per_s: float = PEAK_FLOPS["float32"]) -> float:
    """max(operations / peak, bytes / HBM rate)."""
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)


def share_percent(least_s: float, measured_s: float):
    """100 * least / measured, or None where nothing was measured."""
    if measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
