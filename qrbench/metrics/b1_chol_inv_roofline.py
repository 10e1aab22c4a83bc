"""B1 (``csrc/chol_inv.cu``, fused Cholesky + inverse of a panel's Gram)
as a share of its roofline, in %.  Layer: kernels.  Moves call_ms.

The least time is what the cell's shapes need, whatever implements it:
one Cholesky + triangular inverse of an nb x nb Gram for each of the
ceil(n / nb) panels of every call (CholeskyQR's first round; the second
round's Cholesky is skipped when its Gram is near I, so it is not counted).
Operations nb^3/3 + nb^3/3, bytes: read G, write L and L^-1, float32.
The time is the device time of the B1 events.  None where the trace holds
no B1 event.
"""

from qrbench.roofline import PEAK_FLOPS, least_seconds, share_percent

KERNELS = ("chol_inv_kernel",)


def work(config: dict) -> tuple:
    """(operations, bytes) B1's layer needs for one call of the cell."""
    n, nb = config["shape"][1], config["qr_config"]["panel_width"]
    panels = -(-n // nb)
    return panels * 2 * nb ** 3 / 3, panels * 3 * nb * nb * 4


def read(trace):
    us = sum(e - s for name, s, e in trace.device_events if any(k in name for k in KERNELS))
    if not us:
        return None
    flops, nbytes = work(trace.config)
    least = trace.calls * least_seconds(flops, nbytes, PEAK_FLOPS["float32"])
    return share_percent(least, us / 1e6)
