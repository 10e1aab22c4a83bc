"""B2 (``csrc/geqrt.cu``, Householder geqr2 + larft of a stack of panels)
as a share of its roofline, in %.  Layer: kernels.  Moves call_ms.

The least time is what the cell's shapes need for a TSQR tree: geqr2 +
larft of each of the L = ceil(m / b) leaves of b x n (b = max(block_rows,
2n)), then of each tree node of 2n x n (floor(c / 2) nodes at a level of c
factors, until one is left).  A leaf or node of h x w: operations
2hw^2 - 2w^3/3 (geqr2) + w^2 (h - w/3) (larft) = 3hw^2 - w^3; bytes: read
the block, write the packed block, tau and T, float32.  The time is the
device time of the B2 events.  None where the trace holds no B2 event.
"""

from qrbench.roofline import PEAK_FLOPS, least_seconds, share_percent

KERNELS = ("geqrt_subpanel_kernel", "geqrt_stream_kernel")


def geqrt_work(count: int, h: int, w: int) -> tuple:
    """(operations, bytes) of geqr2 + larft of ``count`` blocks of h x w."""
    return count * (3 * h * w * w - w ** 3), count * (2 * h * w + w + w * w) * 4


def work(config: dict) -> tuple:
    """(operations, bytes) B2's layer needs for one TSQR call of the cell."""
    m, n = config["shape"]
    b = max(config["qr_config"]["block_rows"], 2 * n)
    factors = -(-m // b)
    flops, nbytes = geqrt_work(factors, b, n)
    while factors > 1:
        nodes = factors // 2
        f, by = geqrt_work(nodes, 2 * n, n)
        flops, nbytes = flops + f, nbytes + by
        factors -= nodes
    return flops, nbytes


def read(trace):
    us = sum(e - s for name, s, e in trace.device_events if any(k in name for k in KERNELS))
    if not us:
        return None
    flops, nbytes = work(trace.config)
    least = trace.calls * least_seconds(flops, nbytes, PEAK_FLOPS["float32"])
    return share_percent(least, us / 1e6)
